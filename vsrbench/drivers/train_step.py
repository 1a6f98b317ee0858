"""Training steps fed by the program's loader: ``frvsr_train_step`` or
``tecogan_train_step`` (the configuration's ``model``) on batches of
``batch`` clips from a ``TrainLoader`` (``loader_workers`` threads) over a
records store of seeded sequences, written to a temporary directory in
set-up. The loop enqueues ``steps_per_sync`` steps, then reads a log value
back, as the program's training loop does between its log reads; every
batch goes to the card from pinned memory without blocking the host.

Correctness, two checks of the one training state that set-up builds and
the window drives, each against the plain fp32 reference once the window
has closed:

- the start: set-up runs the first ``CHECKED_STEPS`` steps through the
  window's own call and feed; the reference follows them from the seed's
  weights on the same batches;
- a step of the window: the first step of a unit drawn from the seed among
  the first ``WINDOW_CHECK_UNITS``; its parameters and Adam moments are
  copied on the card before and after it, and the reference replays it
  from the copy taken before (the program's own state), on its batch.

Compared: each step's losses; the gradient as the optimizer got it (from
Adam's first moment: (m_after - beta1 m_before) / (1 - beta1)); the
parameters' change. Gradients and changes are taken leaf by leaf as the
gap between the program's norm and the reference's, summarised by the
median leaf of each sub-network (FNet, SRNet, the discriminator) and by
the worst leaf.
"""

from __future__ import annotations

import functools
import itertools
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import counts, weights
from ..reference import nets as ref
from ..reference import train as ref_train
from ..trace import profile, span

GAN_TERMS = ("l_pix_G", "l_warp_G", "l_feat_G", "l_pp_G", "l_gan_G",
             "l_gan_D")
FRVSR_TERMS = ("l_pix_G", "l_warp_G")

CHECKED_STEPS = 3          # set-up's first steps, which the reference follows
WINDOW_CHECK_UNITS = 4     # the window's checked step: in one of its first units
DISPATCH_SAMPLES = 3       # steps timed alone for dispatch_ms.train
TRACE_UNITS = 1            # units under the profiler
# threads the native clip assembler takes per sample (the program's
# default is 4): the recipe's loader workers are single-threaded, and four
# each would put twelve assembler threads beside the launching thread on
# the card host's eight cores
ASSEMBLER_THREADS = 1


def write_store(path: str, store: dict, gen: torch.Generator, device):
    """A records store of ``sequences`` seeded uint8 sequences of
    ``frames`` x ``height`` x ``width`` RGB, drawn on the device. With
    ``contrast`` [lo, hi], each sequence's values spread about mid-grey by
    a factor drawn uniformly from it, so that clips differ as a video's
    scenes do (and a batch's halves have different losses)."""
    from tecogan_tpu_torch.data import RecordWriter

    w = RecordWriter(path)
    shape = (store["frames"], store["height"], store["width"], 3)
    for i in range(store["sequences"]):
        frames = torch.randint(0, 256, shape, generator=gen, device=device,
                               dtype=torch.uint8)
        if "contrast" in store:
            lo, hi = store["contrast"]
            c = lo + (hi - lo) * torch.rand((), generator=gen, device=device)
            frames = (127.5 + c * (frames.float() - 127.5)).round().to(
                torch.uint8)
        w.add_sequence(f"s{i:04d}", frames.cpu().numpy())
    w.close()


def sub_network(net: str, leaf: str) -> str:
    """The sub-network a leaf belongs to: the generator's first module
    (``fnet``, ``srnet``), or the discriminator (``d``)."""
    return leaf.split(".")[0] if net == "g" else net


def leaf_gaps(net: str, prog: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's of
    its sub-network. ``keep``: the leaves compared (default all)."""
    ref_n = {k: float(want[k].norm()) for k in want
             if keep is None or k in keep}
    subs = {}
    for k, v in ref_n.items():
        subs.setdefault(sub_network(net, k), []).append(v)
    med = {sub: float(np.median(v)) for sub, v in subs.items()}
    return {k: abs((float(prog[k].norm()) if k in prog else 0.0) - v)
            / max(v, med[sub_network(net, k)], 1e-30)
            for k, v in ref_n.items()}


def summary(kind: str, per_net: dict) -> dict:
    """``<kind>_gap`` and ``<kind>_leaf``, the worst leaf's gap and name,
    and ``<kind>_mid.<sub-network>``, each sub-network's median leaf gap,
    from {net: {leaf: gap}}."""
    out, groups = {f"{kind}_gap": 0.0, f"{kind}_leaf": None}, {}
    for net, gaps in sorted(per_net.items()):
        for leaf, gap in gaps.items():
            groups.setdefault(sub_network(net, leaf), []).append(gap)
            if gap >= out[f"{kind}_gap"]:
                out[f"{kind}_gap"], out[f"{kind}_leaf"] = gap, f"{net}.{leaf}"
    for name, gaps in sorted(groups.items()):
        out[f"{kind}_mid.{name}"] = float(np.median(gaps))
    return out


def readings(prog, want, names: dict, left_out=()) -> dict:
    """The numbers compared, from (losses per step, gradients, changes) of
    the program and of the reference (``names``: {net: its leaves}): each
    step's loss terms (but ``left_out``) by the worst relative gap; the
    gradients and the changes by ``summary``; TecoGAN's vote, its distance
    by the largest gap and its rule (1 where the program's D update
    disagrees with its own distance). A net with a gradient on one side
    only reads 1 in every leaf, on neither side 0. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    change (they move by round-off alone)."""
    pl, pg, pc = prog[:3]
    rl, rg, rc = want[:3]
    loss_gap = vote_gap = vote_rule = 0.0
    terms = {}
    for a, b in zip(pl, rl):
        if "distance" in b:
            vote_gap = max(vote_gap, abs(a["distance"] - b["distance"]))
            vote_rule = max(vote_rule, a.get("vote_rule", 0.0))
        for t in b:
            if t == "distance":
                continue
            den = abs(b[t])
            gap = abs(a[t] - b[t])
            gap = gap / den if den > 0 else (
                0.0 if gap == 0 else float("inf"))
            terms[t] = max(terms.get(t, 0.0), gap)
            if t not in left_out:
                loss_gap = max(loss_gap, gap)
    grads = {}
    for net, leaves in names.items():
        if net in pg and net in rg:
            grads[net] = leaf_gaps(net, pg[net], rg[net])
        else:
            grads[net] = dict.fromkeys(
                leaves, 0.0 if net not in pg and net not in rg else 1.0)
    changes, left_out_leaves = {}, 0
    for net in rc:
        norms = {k: float(v.norm()) for k, v in rg.get(net, {}).items()}
        med = float(np.median(list(norms.values()))) if norms else 0.0
        keep = ({k for k, v in norms.items() if v >= 1e-3 * med}
                if norms else None)
        left_out_leaves += len(norms) - len(keep) if norms else 0
        changes[net] = leaf_gaps(net, pc[net], rc[net], keep)
    out = {"loss_gap": loss_gap, **summary("grad", grads),
           **summary("change", changes), "leaves_left_out": left_out_leaves,
           **{f"loss_gap.{t}": v for t, v in terms.items()},
           **{f"ref.{t}": v for t, v in rl[0].items()}}
    if any("distance" in b for b in rl):
        out.update(vote_gap=vote_gap, vote_rule=vote_rule)
    return out


def _stream(loader):
    """The loader's batches, epoch after epoch; closing it stops the
    loader's producer thread."""
    for epoch in itertools.count():
        yield from loader.epoch(epoch)


class Driver:
    kind = "train"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        # read by the program's native assembler when it first loads
        os.environ["TECOGAN_LOADER_THREADS"] = str(ASSEMBLER_THREADS)
        from tecogan_tpu_torch.data import TrainLoader, UnpairedClipDataset
        from tecogan_tpu_torch.models import schedules, steps
        from tecogan_tpu_torch.models.networks import (VGG19, DTrunk, FRNet,
                                                       FRNetConfig,
                                                       STNetConfig)

        self.config, self.mix, self.device = config, mix, device
        self.gan = config["model"] == "TecoGAN"
        g, tr = config["generator"], config["train"]
        deg = config["degradation"]
        self.dims = (g["nf"], g["nb"], config["scale"])
        self.crop = tr["crop_size"]
        cfg_g = FRNetConfig(nf=g["nf"], nb=g["nb"], scale=config["scale"],
                            degradation=deg["type"], remat=g["remat"])
        gen = weights.generator(seed, device)
        self.sd = {"g": weights.random_state(
            weights.layout(ref.FRNet, *self.dims), gen, device)}
        net_g = FRNet.from_state_dict(cfg_g, self.sd["g"], device).train()
        crit = {k: tr[k] for k in ("pixel_crit", "warping_crit",
                                   "feature_crit", "pingpong_crit",
                                   "gan_crit") if k in tr}
        tcfg = steps.TrainConfig(
            scale=config["scale"], degradation=deg["type"],
            sigma=deg["sigma"], mixed_precision=tr["mixed_precision"],
            tempo_extent=tr["tempo_extent"], **crit,
            **({k: tr["discriminator"][k]
                for k in ("update_policy", "update_threshold",
                          "crop_border_ratio")} if self.gan else {}))
        opt_g, sched_g = schedules.make_adam(dict(tr["generator"]),
                                             net_g.parameters())
        self.betas = tuple(tr["generator"]["betas"])
        if self.gan:
            dc = config["discriminator"]
            cfg_d = STNetConfig(in_nc=dc["in_nc"], spatial_size=self.crop,
                                tempo_range=dc["tempo_range"])
            self.sd["d"] = weights.random_state(
                weights.layout(ref.DTrunk, cfg_d.in_channels, self.crop),
                gen, device)
            self.sd["vgg"] = weights.random_state(
                weights.layout(ref.VGG19), gen, device)
            net_d = DTrunk.from_state_dict(cfg_d, self.sd["d"], device)
            vgg = VGG19.from_state_dict(self.sd["vgg"], device)
            opt_d, sched_d = schedules.make_adam(
                dict(tr["discriminator"]), net_d.parameters())
            self.state = steps.tecogan_init_state(net_g, net_d, opt_g, opt_d)
            self.step = functools.partial(
                steps.tecogan_train_step, cfg_g=cfg_g, cfg_d=cfg_d,
                tcfg=tcfg, sched_g=sched_g, sched_d=sched_d, vgg=vgg)
            self.nets = {"g": net_g, "d": net_d}
            self.opts = {"g": opt_g, "d": opt_d}
        else:
            self.state = steps.frvsr_init_state(net_g, opt_g)
            self.step = functools.partial(steps.frvsr_train_step,
                                          cfg_g=cfg_g, tcfg=tcfg,
                                          sched_g=sched_g)
            self.nets = {"g": net_g}
            self.opts = {"g": opt_g}

        self.store_dir = tempfile.mkdtemp(prefix="vsrbench_store_")
        write_store(self.store_dir, mix["store"], gen, device)
        border = int(3.0 * deg["sigma"])
        ds = UnpairedClipDataset(
            self.store_dir, crop_size=self.crop + 2 * border,
            tempo_extent=tr["tempo_extent"],
            moving_first_frame=tr["moving_first_frame"],
            moving_factor=tr["moving_factor"], output_dtype=np.uint8)
        loader = TrainLoader(ds, batch_size=mix["batch"], seed=seed,
                             num_workers=mix["loader_workers"])
        self.batches = _stream(loader)
        self.spans = []
        self.check_unit = int(np.random.default_rng(seed % 2 ** 64).integers(
            0, WINDOW_CHECK_UNITS))
        self.units, self.window = 0, None

        # the checked steps: the window's own call and feed, recorded
        with torch.no_grad():
            self.p0 = self._params()
        self.names = {net: list(p) for net, p in self.p0.items()}
        self.checked, self.grad1 = [], None
        for k in range(CHECKED_STEPS):
            batch, logs = self._one_step()
            self.checked.append((batch["gt"].clone(), logs))
            if k == 0:
                self.grad1 = self._first_moments()
        self.p_end = self._params()
        self._sync()
        self.spans.clear()

    # ---------------------------------------------------------- the loop

    def _params(self) -> dict:
        return {net: {k: p.detach().clone() for k, p in m.named_parameters()}
                for net, m in self.nets.items()}

    def _moments(self) -> dict:
        """A copy of each net's Adam state: {net: {leaf: {exp_avg,
        exp_avg_sq, step}}}, for the leaves that have one."""
        out = {}
        for net, m in self.nets.items():
            st = self.opts[net].state
            out[net] = {k: {s: st[p][s].clone() for s in
                            ("exp_avg", "exp_avg_sq", "step")}
                        for k, p in m.named_parameters() if p in st}
        return out

    def _first_moments(self) -> dict:
        """Each net's gradient of the first step as Adam got it: its first
        moment after one update over 1 - beta1 (a net whose update was
        skipped has none)."""
        b1 = self.betas[0]
        return {net: {k: s["exp_avg"] / (1.0 - b1) for k, s in mom.items()}
                for net, mom in self._moments().items() if mom}

    def _d_count(self):
        return self.state["cnt_upd_d"].clone() if self.gan else None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one_step(self):
        with span(self.spans, "batch_wait"):
            arrays = next(self.batches)
        batch = {}
        for k, v in arrays.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory()
            batch[k] = t.to(self.device, non_blocking=True)
        with span(self.spans, "step"):
            self.state, logs = self.step(self.state, batch)
        return batch, logs

    def _window_step(self):
        """The window's checked step, with copies of the state on the card
        before and after it (no host sync)."""
        before = {"params": self._params(), "moments": self._moments(),
                  "d_count": self._d_count()}
        batch, logs = self._one_step()
        self.window = {"gt": batch["gt"], "logs": logs, "before": before,
                       "params": self._params(), "moments": self._moments()}
        return logs

    def pending(self) -> bool:
        """Whether the window's checked step has yet to run."""
        return self.window is None

    def unit(self) -> int:
        """``steps_per_sync`` steps, then a log value read back: the clips
        the steps consumed."""
        for i in range(self.mix["steps_per_sync"]):
            if i == 0 and self.pending() and self.units == self.check_unit:
                logs = self._window_step()
            else:
                _, logs = self._one_step()
        with span(self.spans, "log_read"):
            float(logs["l_pix_G"])
        self.units += 1
        return self.mix["steps_per_sync"] * self.mix["batch"]

    def rates(self, units: int, seconds: float) -> dict:
        return {"train_clips_per_s": units / seconds}

    def trace(self) -> dict:
        waits = [e - s for name, s, e in self.spans if name == "batch_wait"]
        dispatch = []
        for _ in range(DISPATCH_SAMPLES):
            self._sync()
            arrays = next(self.batches)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in arrays.items()}
            self._sync()
            t0 = time.perf_counter()
            self.state, _ = self.step(self.state, batch)
            dispatch.append(time.perf_counter() - t0)
        self._sync()
        upd0 = self._d_updates()
        tr = profile(lambda: sum(self.unit() for _ in range(TRACE_UNITS)),
                     lambda clips: clips, self.device)
        nf, nb, s = self.dims
        b, te = self.mix["batch"], self.config["train"]["tempo_extent"]
        lh = self.crop // s
        steps = TRACE_UNITS * self.mix["steps_per_sync"]
        if self.gan:
            upd = self._d_updates() - upd0
            flops = (upd * counts.tecogan_step_flops(b, te, lh, lh, nf, nb, s,
                                                     self.crop, True)
                     + (steps - upd) * counts.tecogan_step_flops(
                         b, te, lh, lh, nf, nb, s, self.crop, False))
        else:
            flops = steps * counts.generator_train_flops(b, te, lh, lh, nf, nb,
                                                         s)
        dt = "bfloat16" if self.config["train"]["mixed_precision"] \
            else "float32"
        return {"kind": "train", "trace": tr, "dispatch_s": dispatch,
                "batch_wait_s": waits, "flops_in_trace": flops,
                "steps": DISPATCH_SAMPLES + steps,
                "k3k4_bytes": counts.warp_adjoint_bytes(
                    b, 3, self.crop, self.crop, dt, dt)}

    def _d_updates(self) -> int:
        return int(float(self.state["cnt_upd_d"])) if self.gan else 0

    def release(self):
        """Stop the loader, free the program's state, remove the store."""
        self.batches.close()
        del self.state, self.step, self.nets, self.opts
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.store_dir, ignore_errors=True)

    # --------------------------------------------------------- the check

    def _program_votes(self) -> list:
        """Whether the program updated D in each checked step of the start
        (its update count's increments)."""
        seen = [0.0] + [float(logs["n_upd_D"]) for _, logs in self.checked]
        return [b > a for a, b in zip(seen, seen[1:])]

    def _window_vote(self) -> bool:
        w = self.window
        return float(w["logs"]["n_upd_D"]) > float(w["before"]["d_count"])

    def _losses(self, logs: dict, updated: bool) -> dict:
        terms = GAN_TERMS + ("distance",) if self.gan else FRVSR_TERMS
        out = {t: float(logs[t]) for t in terms}
        if self.gan:
            thr = self.config["train"]["discriminator"]["update_threshold"]
            # 1 where the program's branch disagrees with its own vote
            out["vote_rule"] = float(updated != (out["distance"] < thr))
        return out

    def program_readings(self) -> tuple:
        """The start's (losses per checked step, first gradients, parameter
        changes) of the program."""
        votes = self._program_votes() if self.gan else [True] * len(
            self.checked)
        losses = [self._losses(logs, upd)
                  for (_, logs), upd in zip(self.checked, votes)]
        change = {net: {k: self.p_end[net][k] - self.p0[net][k]
                        for k in self.p0[net]} for net in self.p0}
        return losses, self.grad1, change

    def window_program_readings(self) -> tuple:
        """The window step's ([losses], gradients, changes) of the
        program: each gradient from Adam's first moment before and after
        it (a net whose update was skipped has none)."""
        w, b1 = self.window, self.betas[0]
        updated = self._window_vote() if self.gan else True
        grads = {}
        for net, mom in w["moments"].items():
            if net == "d" and not updated:
                continue
            m0 = w["before"]["moments"].get(net, {})
            grads[net] = {
                k: (s["exp_avg"] - b1 * m0[k]["exp_avg"] if k in m0
                    else s["exp_avg"]) / (1.0 - b1)
                for k, s in mom.items()}
        change = {net: {k: w["params"][net][k] - w["before"]["params"][net][k]
                        for k in w["params"][net]} for net in w["params"]}
        return [self._losses(w["logs"], updated)], grads, change

    def _reference_run(self, batches, votes, rounding, start=None) -> tuple:
        """The reference's (losses per step, first step's gradients,
        parameter changes, D updates taken) over ``batches`` (uint8 GT),
        from the seed's weights, or from ``start`` ({"params", "moments"}:
        a copy of the program's state, weights and Adam moments). ``votes``
        None lets the reference's own vote decide D's updates, a list
        follows it. ``rounding``: ``reference.ops.ROUND``'s."""
        tr = self.config["train"]
        dev = self.device
        start = start or {"params": {}, "moments": {}}

        def state_dict(net):
            return {**self.sd[net], **start["params"].get(net, {})}

        nets = {"g": ref.load(ref.FRNet(*self.dims), state_dict("g"), dev)}
        if self.gan:
            nets["d"] = ref.load(ref.DTrunk(27, self.crop), state_dict("d"),
                                 dev).train()
            vgg = ref.load(ref.VGG19(), self.sd["vgg"], dev).eval()
            vgg.requires_grad_(False)
        adams = {}
        for k, m in nets.items():
            opt = tr["generator" if k == "g" else "discriminator"]
            adam = ref_train.Adam(ref_train.trainable(m), opt["lr"],
                                  tuple(opt["betas"]))
            mom = start["moments"].get(k, {})
            for leaf, s in mom.items():
                adam.m[leaf].copy_(s["exp_avg"])
                adam.v[leaf].copy_(s["exp_avg_sq"])
                adam.t = int(s["step"])
            adams[k] = adam
        p0 = {k: {n: p.detach().clone() for n, p in m.named_parameters()}
              for k, m in nets.items()}
        cfg = {"scale": self.dims[2], "sigma": self.config["degradation"][
            "sigma"], "pixel_weight": tr["pixel_crit"]["weight"],
               "warping_weight": tr["warping_crit"]["weight"]}
        if self.gan:
            cfg.update(d_size=self.crop,
                       crop_border_ratio=tr["discriminator"][
                           "crop_border_ratio"],
                       update_threshold=tr["discriminator"][
                           "update_threshold"],
                       pingpong_weight=tr["pingpong_crit"]["weight"],
                       gan_weight=tr["gan_crit"]["weight"],
                       feature_weight=tr["feature_crit"]["weight"],
                       feature_layers=tr["feature_crit"]["feature_layers"])
        losses, grad1, taken = [], None, []
        ref.ROUND["to"] = rounding
        try:
            with ref_train.no_tf32():
                for k, gt in enumerate(batches):
                    if self.gan:
                        l, gg, gd = ref_train.tecogan_step(
                            nets["g"], nets["d"], vgg, adams["g"],
                            adams["d"], gt, cfg,
                            None if votes is None else votes[k])
                        g1 = {"g": gg, **({"d": gd} if gd else {})}
                        taken.append(gd is not None)
                    else:
                        l, gg = ref_train.frvsr_step(nets["g"], adams["g"],
                                                     gt, cfg)
                        g1 = {"g": gg}
                        taken.append(True)
                    losses.append({n: float(v) for n, v in l.items()})
                    if k == 0:
                        grad1 = {n: {a: b.detach().clone()
                                     for a, b in v.items()}
                                 for n, v in g1.items()}
        finally:
            ref.ROUND["to"] = None
        change = {k: {n: p.detach() - p0[k][n]
                      for n, p in m.named_parameters()}
                  for k, m in nets.items()}
        return losses, grad1, change, taken

    def reference(self, rounding: str | None = None,
                  votes="program") -> tuple:
        """The reference over the start's checked batches from the seed's
        weights. ``votes``: "program" follows the program's D updates (the
        vote's distance is compared apart), a list follows those, None lets
        the reference's own vote decide. ``rounding`` "fp8": the control's
        operands."""
        if votes == "program":
            votes = self._program_votes() if self.gan else None
        return self._reference_run([gt for gt, _ in self.checked], votes,
                                   rounding)

    def reference_window(self, rounding: str | None = None,
                         votes="program") -> tuple:
        """The reference over the window's checked step, from the copy of
        the program's state taken before it; ``votes`` as ``reference``'s."""
        if votes == "program":
            votes = [self._window_vote()] if self.gan else None
        return self._reference_run([self.window["gt"]], votes, rounding,
                                   self.window["before"])

    def compare(self, prog: tuple, want: tuple, left_out=()) -> dict:
        """Every number, from the (start, window) readings of a program and
        of a reference: the start's under their own names, the window
        step's under ``win.``."""
        out = readings(prog[0], want[0], self.names, left_out)
        win = readings(prog[1], want[1], self.names, left_out)
        out.update({f"win.{k}": v for k, v in win.items()})
        return out

    def program_pair(self) -> tuple:
        return self.program_readings(), self.window_program_readings()

    def reference_pair(self, rounding: str | None = None,
                       votes=("program", "program")) -> tuple:
        return (self.reference(rounding, votes[0]),
                self.reference_window(rounding, votes[1]))

    def check(self, limits: dict) -> list:
        got = self.compare(self.program_pair(), self.reference_pair(),
                           limits.get("loss_terms_left_out", ()))
        return [{"name": k, "value": got.get(k), "limit": v}
                for k, v in limits["checks"].items()]
