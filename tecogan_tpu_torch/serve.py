"""Serving host: LR frame sequences in -> SR PNG sequences out, driven by a
serving artifact alone (port of ``tecogan_tpu/serve.py``)::

    python -m tecogan_tpu_torch.serve model.tecosrv <in_dir> <out_dir> \
        [--ckpt G_iterN.npz] [--pad_front 5] [--padding_mode reflect]

``in_dir`` is either one sequence (a directory of frames) or a directory
of sequence sub-directories, the folder layout test mode reads. Frames
are PNG, JPEG or BMP (``utils/png.py::read_image``: 8-bit PNGs by its
own decoder, every other file by cv2, imported for them alone) and must
match the artifact's LR geometry (h, w);
sequences shorter than the artifact's fixed ``t`` are tail-padded and
trimmed on output (the recurrence is causal, so the earlier frames are
those of an exact-length program). Streams go through the program in
groups of its ``n``; a last, partial group fills its empty slots with a
copy of its last sequence, whose output is dropped.

The weights come from the artifact when it embeds them (the exporter's
default) or from ``--ckpt`` (``utils/ckpt.load_generator_params``; the
same names and shapes). ``--pad_front`` is test mode's recurrent warm-up
(reflect or replicate pre-roll); the padded frames are trimmed.

The program runs where it was exported for: ``--platforms cuda`` (the
exporter's default) needs a card, and ``cpu`` runs on the CPU. This host
imports the port's kernels and utilities, never its models.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from .utils.png import read_image

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_frames(d):
    return sorted(f for f in os.listdir(d)
                  if f.lower().endswith(IMG_EXTS))


def discover_sequences(in_dir: str):
    """-> list of (name, dir, [frame filenames]). One-sequence dirs keep
    their basename as the sequence name."""
    if not osp.isdir(in_dir):
        raise FileNotFoundError(f"input directory not found: {in_dir}")
    direct = _list_frames(in_dir)
    seqs = []
    for name in sorted(os.listdir(in_dir)):
        sub = osp.join(in_dir, name)
        if osp.isdir(sub):
            frames = _list_frames(sub)
            if frames:
                seqs.append((name, sub, frames))
    if direct and seqs:
        # serving only the loose frames or only the sub-directories would
        # drop frames the user can see
        raise ValueError(
            f"{in_dir} holds both loose image frames ({direct[0]}, ...) and "
            f"sequence sub-directories ({seqs[0][0]}, ...); point --in_dir "
            f"at one sequence directory or remove the stray images")
    if direct:
        return [(osp.basename(osp.normpath(in_dir)), in_dir, direct)]
    if not seqs:
        raise FileNotFoundError(
            f"no image frames (or sequence sub-directories with frames) "
            f"under {in_dir}")
    return seqs


def _read_sequence(seq_dir, frames, h, w, name):
    out = np.empty((len(frames), h, w, 3), np.float32)
    for i, fn in enumerate(frames):
        img = read_image(osp.join(seq_dir, fn))
        if img.shape[:2] != (h, w):
            raise ValueError(
                f"sequence {name!r} frame {fn}: shape {img.shape[:2]} does "
                f"not match the artifact's LR geometry ({h}, {w}); export "
                f"an artifact for this geometry")
        out[i] = img.astype(np.float32) / 255.0
    return out


def _check_fits(t_seq, t, pad_front):
    """Raise unless a sequence of ``t_seq`` frames, with ``pad_front``
    frames of pre-roll, fits the artifact's fixed t."""
    if pad_front >= t_seq:
        # test mode's contract (models/base.py pad_sequence)
        raise ValueError(
            f"--pad_front {pad_front} needs at least {pad_front + 1} "
            f"frames but the sequence has {t_seq}; lower --pad_front")
    if t_seq + pad_front > t:
        raise ValueError(
            f"sequence of {t_seq} frames (+{pad_front} pre-roll) exceeds the "
            f"artifact's fixed t={t}; re-export with --frames >= "
            f"{t_seq + pad_front} (or lower --pad_front)")


def _pad_to_t(seq, t, pad_front, mode):
    """Front pre-roll (reflect/replicate) + edge tail padding to the
    artifact's fixed t. -> (padded (t, h, w, 3), n_front)."""
    _check_fits(len(seq), t, pad_front)
    n_front = pad_front
    if n_front:
        if mode == "reflect":
            front = seq[1:1 + n_front][::-1]
        elif mode == "replicate":
            front = np.broadcast_to(seq[:1], (n_front,) + seq.shape[1:])
        else:
            raise ValueError(f"unrecognized padding mode: {mode}")
        seq = np.concatenate([front, seq], axis=0)
    if len(seq) < t:
        tail = np.broadcast_to(seq[-1:], (t - len(seq),) + seq.shape[1:])
        seq = np.concatenate([seq, tail], axis=0)
    return seq, n_front


def serve(artifact: str, in_dir: str, out_dir: str, ckpt: str | None = None,
          pad_front: int = 0, padding_mode: str = "reflect",
          quiet: bool = False):
    """Run every sequence under ``in_dir`` through the artifact; write SR
    PNG frames (input basenames kept, extension .png: JPEG/BMP inputs are
    read, outputs are never lossy) under ``out_dir``/<seq>/. Returns
    {sequence name: frames written}."""
    from .ops.color import save_sequence
    from .serving import load_stream, read_artifact

    blob, meta, params = read_artifact(artifact)
    missing = [k for k in ("n", "t", "h", "w") if k not in meta]
    if missing:
        raise ValueError(
            f"artifact sidecar lacks geometry keys {missing}; re-export "
            f"with python -m tecogan_tpu_torch.tools.export_serving")
    n, t, h, w = (int(meta[k]) for k in ("n", "t", "h", "w"))

    if ckpt is not None:
        from .utils.ckpt import load_generator_params

        params = load_generator_params(ckpt, nb=int(meta.get("nb", 10)),
                                       scale=int(meta.get("scale", 4)))
    if params is None:
        raise ValueError(
            f"{artifact} has no embedded weights; pass --ckpt (the "
            f"exporter embeds weights unless --no_embed_params was given)")

    seqs = discover_sequences(in_dir)
    for _, _, frames in seqs:  # before the program's seconds of loading
        _check_fits(len(frames), t, pad_front)
    run = load_stream(blob)
    log = (lambda *a: None) if quiet else print
    log(f"[serve] {len(seqs)} sequence(s); artifact geometry "
        f"n={n} t={t} lr={h}x{w} scale={meta.get('scale', '?')}")

    written = {}
    for g0 in range(0, len(seqs), n):
        group = seqs[g0:g0 + n]
        batch = np.empty((n, t, h, w, 3), np.float32)
        fronts, lens = [], []
        for i in range(n):
            if i >= len(group):
                batch[i] = batch[len(group) - 1]
                continue
            name, sdir, frames = group[i]
            seq = _read_sequence(sdir, frames, h, w, name)
            padded, n_front = _pad_to_t(seq, t, pad_front, padding_mode)
            batch[i] = padded
            fronts.append(n_front)
            lens.append(len(seq))
        sr = run(params, batch).cpu().numpy()  # uint8 (n, t, sh, sw, 3)
        for i, (name, _sdir, frames) in enumerate(group):
            out_seq = sr[i, fronts[i]:fronts[i] + lens[i]]
            out_names = [osp.splitext(f)[0] + ".png" for f in frames]
            save_sequence(osp.join(out_dir, name), out_seq,
                          frm_idx_lst=out_names, to_bgr=True)
            written[name] = lens[i]
            log(f"[serve] {name}: {lens[i]} frames -> "
                f"{osp.join(out_dir, name)}")
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.serve",
        description="SR PNG sequences from a serving artifact")
    ap.add_argument("artifact", help=".tecosrv file from "
                    "tecogan_tpu_torch.tools.export_serving")
    ap.add_argument("in_dir", help="LR frames dir, or dir of sequence dirs")
    ap.add_argument("out_dir")
    ap.add_argument("--ckpt", default=None,
                    help="generator checkpoint overriding embedded weights")
    ap.add_argument("--pad_front", type=int, default=0,
                    help="recurrent warm-up pre-roll frames (test mode "
                         "uses 5); trimmed from the output")
    ap.add_argument("--padding_mode", default="reflect",
                    choices=["reflect", "replicate"])
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    return serve(args.artifact, args.in_dir, args.out_dir, ckpt=args.ckpt,
                 pad_front=args.pad_front, padding_mode=args.padding_mode,
                 quiet=args.quiet)


if __name__ == "__main__":
    main()
