"""Data parallelism in the port (``parallel/dist.py``): two real processes
over gloo on the CPU, launched with torchrun's environment as
``tests/test_multihost.py`` launches the JAX package's.

- FRVSR through ``main.train`` for 4 iterations across an epoch boundary at
  1 clip a rank: the two ranks' running logs, weights and gradients are
  identical, and equal the one-process run at the doubled batch;
  checkpoints and the merged validation JSON come from rank 0.
- One TecoGAN step at a global batch of 2, run twice (at D's lr 0 and at
  D's lr), against the JAX package's ``tecogan_train_step`` on the whole
  batch: the logs, D's BatchNorm running stats (global statistics), the
  vote, and G's and D's gradients (read from JAX's Adam state); the Adam
  updates and the gradients against the port's one-process step on the
  whole batch.
- Test mode's round-robin: sequences r, r + 2, ... on rank r, the merged
  metrics JSON equal to the one-process run's.

Tolerances: the ranks against each other exactly (the collectives give
every rank the same bits). Against one process or JAX the sums run in
another order: logs rtol 1e-5 / atol 1e-7 against one process and rtol
1e-4 / atol 1e-6 against JAX (``test_torch_gan_step.py``'s fp32 band),
BatchNorm stats atol 1e-5 (``test_torch_gan_step.py``'s), weights by
``_assert_adam_close``'s rule (Adam at lr 1e-5: an element whose gradient
sits at fp32's noise level may take its step the other way), gradients by
``_GRAD_REL_ONE``, ``_GRAD_REL_JAX`` and ``_GRAD_REL_G_AFTER_D``.

The GAN step runs twice in one launch. At D's lr 0, G reads the same D in
every run, so G's gradient and Adam update are held tightly: 1.6e-6
against one process, 2.8e-6 against JAX, no element of G's Adam update
off (largest 2.6e-8, 0.0026 lr). At D's shipped lr, G reads D after D's
Adam step, in which an element whose gradient sits at fp32's noise level
steps +-lr by the order of summation; G's gradient then moves 5.14e-4
from both one process and JAX, and G's Adam update is not well posed (12
of 7344 elements of conv_in's weight 1.48 lr off, where the rule allows
7.3). There only D's update (at most 1 element off a tensor), D's
gradient, the stats, the vote and the logs are held, and G's gradient at
the JAX band. Both planted faults fail the test (readings on the CPU,
two gloo ranks): the gradient summed without the divide by ``world()``
puts G and D 1.000 off in both runs (and 150357 of 294912 elements of
G's Adam update off); D's BatchNorm backward left on each rank puts D
1.171 off (conv_in's bias), G 0.337 off at D's lr 0 and 0.321 at its lr,
and l_gan_G 1.4% off JAX.
"""

import json
import os
import os.path as osp
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tecogan_tpu.models import schedules as jsched
from tecogan_tpu.models import steps as jsteps
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import STNetConfig as JSTNet
from tecogan_tpu_torch import main as torch_main
from tecogan_tpu_torch.models import convert
from tecogan_tpu_torch.models.networks import (DTrunk, FRNet, FRNetConfig,
                                               STNetConfig)
from tecogan_tpu_torch.parallel import free_port
from tecogan_tpu_torch.utils.ckpt import save_pytree
from tecogan_tpu_torch.utils.png import write_png

from test_torch_train_loop import _opt as _train_opt
from test_torch_train_loop import data  # noqa: F401  (the fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
_LR = 1e-5
# each gradient tensor, by relative L2 error: against one process at the
# doubled batch 1e-4 (measured: 6.0e-7 FRVSR; at D's lr 0 G 1.6e-6 and D
# 7.1e-6); against JAX's global batch G 5e-3 and D 1e-4 (measured at D's
# lr 0: G 2.8e-6, D 9.5e-6). A gradient summed over the ranks and not
# averaged is 1.0 away; with D's BatchNorm backward left on each rank, D's
# is 1.17 away (conv_in's bias) and G's 0.34.
_GRAD_REL_ONE = 1e-4
_GRAD_REL_JAX = {"g": 5e-3, "d": 1e-4}
# G's gradient at D's nonzero lr, against one process and against JAX: G
# reads D after D's Adam step, and D's elements whose gradient sits at
# fp32's noise level take their lr-sized step one way or the other by the
# order of summation, which moves G's gradient by about 5e-4 (measured
# 5.14e-4 against either). So G is held there at the JAX band only.
_GRAD_REL_G_AFTER_D = _GRAD_REL_JAX["g"]


def _launch(tmp_path, code, *args, world=2, timeout=240):
    """Run ``code`` in ``world`` processes with torchrun's environment; each
    prints one line ``RESULT:<json>``. Returns the results in rank order."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(code))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1",
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), *map(str, args)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(tmp_path))
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(out.decode())
    finally:
        for p in procs:  # never orphan a worker holding the port
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("RESULT:"))[len("RESULT:"):])
            for out in outs]


def _assert_grads_close(got, want, tol, what):
    """Each gradient tensor within relative L2 error ``tol`` of the
    other's."""
    for k, v in want.items():
        v = torch.as_tensor(np.asarray(v), dtype=torch.float64)
        err = float((got[k].double() - v).norm() / v.norm())
        assert err <= tol, (what, k, err, tol)


def _assert_adam_close(got, want, start, steps, what):
    """``test_torch_gan_step.py``'s rule over ``steps`` Adam steps at lr
    ``_LR``: the updates within 5% of a step of each other but for at most
    2 elements (or 0.1%), none beyond two flipped steps a step."""
    d = np.abs((got - start) - (want - start))
    off = int((d > 0.05 * _LR).sum())
    assert off <= max(2, 1e-3 * d.size) and d.max() <= 4.2 * _LR * steps, (
        what, off, d.size, d.max())


# ------------------------------------------------------------------ FRVSR

_TRAIN_WORKER = """
    import json, sys
    import torch
    torch.set_num_threads(1)
    from tecogan_tpu_torch import main
    from tecogan_tpu_torch.parallel import dist
    exp, out = sys.argv[1:3]
    model = main.main(["--exp_dir", exp, "--mode", "train", "--opt",
                       exp + "/train.yml", "--gpu_ids", "-1"])
    net = model.net_g
    torch.save({"g": net.state_dict(),
                "grad": {k: p.grad for k, p in net.named_parameters()}},
               f"{out}/g_{dist.rank()}.pt")
    print("RESULT:" + json.dumps({
        "rank": dist.rank(), "world": dist.world(),
        "step": model.state["step"],
        "log": model.get_running_log(model.state)}))
    dist.shutdown()
"""


def _write_opt(exp, opt):
    os.makedirs(exp, exist_ok=True)
    with open(osp.join(exp, "train.yml"), "w") as f:
        yaml.safe_dump(opt, f)


def test_frvsr_train_two_ranks(tmp_path, data):  # noqa: F811
    """2 ranks x 1 clip against 1 process x 2 clips, 4 iterations over an
    epoch of 3, validation at 4 on two sequences (one a rank)."""
    seq_y = data / "ValGT" / "seq_y"
    os.makedirs(seq_y, exist_ok=True)
    for i in range(4):
        write_png(str(seq_y / f"{i:04d}.png"),
                  np.full((32, 40, 3), 40 * i, np.uint8))
    opt = _train_opt(data, total_iter=4, ckpt_freq=2, test_freq=4)
    opt["train"]["generator"]["lr"] = _LR
    one = str(tmp_path / "one")
    _write_opt(one, opt)
    opt2 = json.loads(json.dumps(opt))
    opt2["dataset"]["train"]["batch_size_per_gpu"] = 1
    two = str(tmp_path / "two")
    _write_opt(two, opt2)
    ranks = _launch(tmp_path, _TRAIN_WORKER, two, tmp_path)
    model = torch_main.main(["--exp_dir", one, "--mode", "train", "--opt",
                             osp.join(one, "train.yml"), "--gpu_ids", "-1"])

    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 and r["step"] == 4 for r in ranks)
    assert ranks[0]["log"] == ranks[1]["log"]
    g0, g1 = (torch.load(tmp_path / f"g_{r}.pt") for r in (0, 1))
    for part in ("g", "grad"):
        assert all(torch.equal(g0[part][k], g1[part][k]) for k in g0[part])
    log = model.get_running_log(model.state)
    for k, v in log.items():
        np.testing.assert_allclose(ranks[0]["log"][k], v, rtol=1e-5,
                                   err_msg=k)
    start = FRNet.random(FRNetConfig(nf=8, nb=2),
                         torch.Generator().manual_seed(0)).state_dict()
    for k, v in model.net_g.state_dict().items():
        _assert_adam_close(g0["g"][k].numpy(), v.numpy(), start[k].numpy(),
                           4, k)
    # the last step's gradients: the mean over the ranks is the doubled
    # batch's (Adam's updates above would hide a gradient off by a factor)
    _assert_grads_close(g0["grad"], {k: p.grad for k, p in
                                     model.net_g.named_parameters()},
                        _GRAD_REL_ONE, "FRVSR")
    # rank 0's checkpoints, and the validation JSON merged over the ranks
    ckpts = sorted(os.listdir(osp.join(two, "train", "ckpt")))
    assert ckpts == ["G_iter2.npz", "G_iter4.npz", "state_iter2.pth",
                     "state_iter4.pth"]
    metrics = [json.load(open(osp.join(e, "test", "metrics",
                                       "Val_avg.json"))) for e in (two, one)]
    assert metrics[0] == metrics[1] and list(metrics[0]) == ["G_iter4"]


# ---------------------------------------------------------------- TecoGAN

_GAN_WORKER = """
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from tecogan_tpu_torch.parallel import dist
    sys.path.insert(0, sys.argv[4])
    from test_torch_dist import _LR_D, _gan_step
    dist.init_distributed()
    gt = np.load(sys.argv[1])[dist.shard_rows(2, dist.rank(),
                                              dist.world())]
    logs = []
    for run, lr_d in enumerate(_LR_D):
        nets, run_logs = _gan_step(gt, json.loads(sys.argv[2]), lr_d)
        torch.save(nets, f"{sys.argv[3]}/nets_{run}_{dist.rank()}.pt")
        logs.append(run_logs)
    print("RESULT:" + json.dumps({"logs": logs}))
    dist.shutdown()
"""


def _gan_nets():
    net_g = FRNet.random(FRNetConfig(nf=16, nb=2, scale=4),
                         torch.Generator().manual_seed(9))
    net_d = DTrunk.random(STNetConfig(spatial_size=32),
                          torch.Generator().manual_seed(5))
    return net_g, net_d


_OPT_G = {"lr": _LR, "betas": [0.9, 0.999]}
_OPT_D = {"lr": _LR, "betas": [0.5, 0.999],
          "lr_schedule": {"type": "MultiStepLR", "milestones": [1],
                          "gamma": 0.5}}
# the GAN step runs twice in one launch: (a) at D's lr 0, so that G reads
# the same D in every run, and (b) at D's lr as shipped
_LR_D = (0.0, _LR)


def _gan_step(gt, kw, lr_d):
    """One port TecoGAN step on the uint8 batch ``gt`` with D's Adam at
    ``lr_d``: (the nets' state dicts, the logs as floats)."""
    from tecogan_tpu_torch.models import schedules, steps

    net_g, net_d = _gan_nets()
    og, sg = schedules.make_adam(_OPT_G, net_g.parameters())
    od, sd = schedules.make_adam({**_OPT_D, "lr": lr_d}, net_d.parameters())
    state = steps.tecogan_init_state(net_g, net_d, og, od)
    state, logs = steps.tecogan_train_step(
        state, {"gt": torch.from_numpy(gt)},
        cfg_g=FRNetConfig(nf=16, nb=2, scale=4),
        cfg_d=STNetConfig(spatial_size=32), tcfg=steps.TrainConfig(**kw),
        sched_g=sg, sched_d=sd)
    grads = {f"{n}_grad": {k: p.grad for k, p in net.named_parameters()}
             for n, net in (("g", net_g), ("d", net_d))}
    return ({"g": net_g.state_dict(), "d": net_d.state_dict(), **grads},
            {k: float(v) for k, v in logs.items()})


def _jax_grads(opt_state, beta1):
    """The gradient of a first Adam step, from optax's state: its first
    moment is ``(1 - beta1) * g``."""
    mu = next(s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return jax.tree.map(lambda m: np.asarray(m) / (1 - beta1), mu)


def test_gan_step_two_ranks_matches_jax_global_batch(tmp_path):
    """One TecoGAN step (STNet, ping-pong, the adaptive vote at its 0.4)
    at 1 clip a rank, at D's lr 0 (a) and at D's lr (b): the logs, D's
    BatchNorm running stats and the vote against
    ``jax.jit(tecogan_train_step)`` at 2 clips, the weights against the
    port's one-process step at 2 clips. G's weights and its tight gradient
    band are held in (a) only: in (b) G reads D after D's Adam step."""
    _cb = {"type": "CB", "weight": 1, "reduction": "mean"}
    kw = dict(scale=4, degradation="BD", sigma=1.5, tempo_extent=3,
              pixel_crit=_cb, warping_crit=_cb,
              pingpong_crit={**_cb, "weight": 0.5},
              gan_crit={"type": "GAN", "weight": 0.01, "reduction": "mean"},
              update_policy="adaptive", update_threshold=0.4,
              crop_border_ratio=0.75)
    gt = (np.random.default_rng(11).random((2, 3, 40, 40, 3))
          * 255).astype(np.uint8)
    np.save(tmp_path / "gt.npy", gt)
    # the workers run while JAX compiles its step here
    box = {}
    th = threading.Thread(target=lambda: box.update(ranks=_launch(
        tmp_path, _GAN_WORKER, tmp_path / "gt.npy", json.dumps(kw),
        tmp_path, osp.dirname(osp.abspath(__file__)))))
    th.start()
    try:
        net_g, net_d = _gan_nets()
        tx_g, _ = jsched.make_adam(_OPT_G)
        tx_d, sched_d = jsched.make_adam(_OPT_D, external_lr=True)
        jstate0 = jsteps.tecogan_init_state(
            jax.tree.map(jnp.asarray, convert.jax_from_state_dict(
                net_g.state_dict(), 2, 4)),
            jax.tree.map(jnp.asarray, convert.jax_from_d_state_dict(
                net_d.state_dict(), 32)), tx_g, tx_d)

        def jstep(state, batch, lr_scale):  # one compile for both lrs
            return jsteps.tecogan_train_step(
                state, batch, cfg_g=JCfg(nf=16, nb=2, scale=4,
                                         degradation="BD"),
                cfg_d=JSTNet(spatial_size=32, degradation="BD", scale=4),
                tcfg=jsteps.TrainConfig(**kw), tx_g=tx_g, tx_d=tx_d,
                sched_d=lambda step: lr_scale * sched_d(step))

        jstep = jax.jit(jstep)
        jax_runs = [jstep(jstate0, {"gt": jnp.asarray(gt)},
                          jnp.float32(lr / _LR)) for lr in _LR_D]
        ones = [_gan_step(gt, kw, lr) for lr in _LR_D]
    finally:
        th.join()
    ranks = box["ranks"]
    start = {"g": net_g.state_dict(), "d": net_d.state_dict()}

    for run, lr_d in enumerate(_LR_D):
        (jstate, lj), (one, one_logs) = jax_runs[run], ones[run]
        # the ranks agree bit for bit, the vote included
        assert ranks[0]["logs"][run] == ranks[1]["logs"][run]
        nets = [torch.load(tmp_path / f"nets_{run}_{r}.pt") for r in (0, 1)]
        for part in nets[0]:
            assert all(torch.equal(nets[0][part][k], nets[1][part][k])
                       for k in nets[0][part])
        logs = ranks[0]["logs"][run]
        assert logs["n_upd_D"] == float(lj["n_upd_D"]) == 1.0  # the vote
        for k in jsteps.TECOGAN_LOG_KEYS:
            np.testing.assert_allclose(logs[k], float(lj[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{run} {k}")
            np.testing.assert_allclose(logs[k], one_logs[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{run} {k}")
        # D's BatchNorm running stats: the global batch's, three forwards
        want_d = convert.d_state_dict_from_jax(
            jax.tree.map(np.asarray, jstate["d"]), 32)
        for k, v in nets[0]["d"].items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), want_d[k], rtol=0,
                                           atol=1e-5, err_msg=f"{run} {k}")
        # the gradients: the mean over the ranks is the global batch's,
        # the port's one process's and JAX's (Adam's first step, about lr
        # times the gradient's sign, would hide a gradient off by a factor)
        jax_grads = {
            "g": convert.state_dict_from_jax(
                _jax_grads(jstate["opt_g"], _OPT_G["betas"][0]), 2, 4),
            "d": convert.d_state_dict_from_jax(
                _jax_grads(jstate["opt_d"], _OPT_D["betas"][0]), 32)}
        rel_one = {"g": _GRAD_REL_ONE if lr_d == 0 else _GRAD_REL_G_AFTER_D,
                   "d": _GRAD_REL_ONE}
        rel_jax = {"g": _GRAD_REL_JAX["g"] if lr_d == 0
                   else _GRAD_REL_G_AFTER_D, "d": _GRAD_REL_JAX["d"]}
        for net in ("g", "d"):
            got = nets[0][f"{net}_grad"]
            _assert_grads_close(got, one[f"{net}_grad"], rel_one[net],
                                f"{net} against one process, run {run}")
            _assert_grads_close(got, {k: jax_grads[net][k] for k in got},
                                rel_jax[net], f"{net} against JAX, run {run}")
        # the Adam updates: G's in (a), D's in (b); D in (a) stays put
        held = "g" if lr_d == 0 else "d"
        for k, v in nets[0][held].items():
            if v.is_floating_point() and "running" not in k:
                _assert_adam_close(v.numpy(), one[held][k].numpy(),
                                   start[held][k].numpy(), 1,
                                   f"{held} {k}, run {run}")
        if lr_d == 0:
            for k, v in nets[0]["d"].items():
                if "running" not in k and "num_batches" not in k:
                    assert torch.equal(v, start["d"][k]), k


# -------------------------------------------------------------- test mode

_TEST_WORKER = """
    import json, sys
    import torch
    torch.set_num_threads(1)
    from tecogan_tpu_torch import main
    from tecogan_tpu_torch.parallel import dist
    exp = sys.argv[1]
    records = main.main(["--exp_dir", exp, "--mode", "test", "--opt",
                         exp + "/test.yml", "--gpu_ids", "-1"])
    print("RESULT:" + json.dumps({
        "seqs": [r["seq_idx"] for r in records],
        "metrics": {r["seq_idx"]: r["metrics"] for r in records}}))
    dist.shutdown()
"""


def test_test_mode_round_robin(tmp_path, rng):
    """Three sequences on two ranks: rank 0 takes 0 and 2, rank 1 takes 1;
    the metrics JSON rank 0 writes equals the one-process run's."""
    net = FRNet.random(FRNetConfig(nf=8, nb=2),
                       torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "G_iter1.npz")
    save_pytree(convert.jax_from_state_dict(net.state_dict(), 2, 4), ckpt)
    gt = tmp_path / "GT"
    for s in range(3):
        os.makedirs(gt / f"seq{s}")
        for i in range(3):
            write_png(str(gt / f"seq{s}" / f"{i:04d}.png"),
                      rng.integers(0, 256, (32, 40, 3), dtype=np.uint8))
    opt = {"scale": 4, "manual_seed": 0,
           "dataset": {"degradation": {"type": "BD", "sigma": 1.5},
                       "test": {"name": "Toy", "gt_seq_dir": str(gt)}},
           "model": {"name": "FRVSR", "generator": {
               "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 8, "nb": 2,
               "load_path": ckpt}},
           "test": {"save_res": False, "save_json": True,
                    "padding_mode": "reflect", "num_pad_front": 1},
           "metric": {"PSNR": {"colorspace": "y"},
                      "SSIM": {"colorspace": "y"}}}
    for exp in ("one", "two"):
        _write_opt(str(tmp_path / exp), opt)
        os.replace(tmp_path / exp / "train.yml", tmp_path / exp / "test.yml")
    ranks = _launch(tmp_path, _TEST_WORKER, tmp_path / "two")
    records = torch_main.main(["--exp_dir", str(tmp_path / "one"), "--mode",
                               "test", "--opt",
                               str(tmp_path / "one" / "test.yml"),
                               "--gpu_ids", "-1"])
    assert [r["seqs"] for r in ranks] == [["seq0", "seq2"], ["seq1"]]
    assert [r["seq_idx"] for r in records] == ["seq0", "seq1", "seq2"]
    for r in ranks:
        for seq, m in r["metrics"].items():
            want = next(x["metrics"] for x in records if x["seq_idx"] == seq)
            assert m == pytest.approx(want, rel=1e-12), seq
    got, want = (json.load(open(tmp_path / e / "test" / "metrics" /
                                "Toy_avg.json")) for e in ("two", "one"))
    assert got == want and list(got) == ["G_iter1"]
