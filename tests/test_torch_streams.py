"""Port parity for stream-split batched inference
(``tecogan_tpu_torch/parallel/streams.py::infer_streams``), the counterpart
of ``tests/test_sharded_inference.py::test_dp_sharded_batch_inference``:
the JAX generator's weights (nf=8, nb=2, 4x BD, from ``init_frnet``) bridged
into the port, LR from a numpy seed.

Tolerances: on ``["cpu"] * k`` the split is bit for bit the port's
unsplit ``infer_sequence_batch`` (each block runs the same recurrence on
its own streams). Against ``jax.jit(infer_sequence_batch)`` with the LR
sharded by ``batch_sharding`` over the 8-device CPU mesh: within 1 gray
level on < 1% of values, that test's own bar (torch's and XLA's
convolutions round differently on .5 boundaries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import infer_sequence_batch as jbatch
from tecogan_tpu.models.networks import init_frnet
from tecogan_tpu.parallel import batch_sharding, get_mesh, replicated
from tecogan_tpu_torch.models.convert import state_dict_from_jax
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
from tecogan_tpu_torch.parallel import infer_streams
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CHUNK = 5


@pytest.fixture(scope="module")
def case():
    jcfg = JCfg(nf=8, nb=2, scale=4, degradation="BD")
    params = init_frnet(jax.random.PRNGKey(0), jcfg)
    cfg = FRNetConfig(nf=8, nb=2, scale=4, degradation="BD")
    net = FRNet.from_state_dict(cfg, state_dict_from_jax(params, 2, 4),
                                device="cpu")
    lr = np.random.default_rng(0).random((8, 5, 16, 16, 3)).astype(
        np.float32)
    want = infer_sequence_batch(net, torch.from_numpy(lr), cfg, CHUNK)
    return jcfg, params, cfg, net, lr, want


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_split_equals_the_unsplit_batch(case, k):
    _, _, cfg, net, lr, want = case
    got = infer_streams(net, torch.from_numpy(lr), cfg, ["cpu"] * k, CHUNK)
    assert got.shape == (8, 5, 64, 64, 3) and got.dtype == torch.uint8
    assert torch.equal(got, want)


def test_split_matches_jax_dp_sharded_batch(case):
    jcfg, params, cfg, net, lr, _ = case
    mesh = get_mesh()
    assert mesh.devices.size == 8
    run = jax.jit(lambda p, x: jbatch(p, x, jcfg, chunk=CHUNK))
    want = np.asarray(run(jax.device_put(params, replicated(mesh)),
                          jax.device_put(jnp.asarray(lr),
                                         batch_sharding(mesh))))
    got = infer_streams(net, torch.from_numpy(lr), cfg, ["cpu"] * 8,
                        CHUNK).numpy()
    assert got.shape == want.shape == (8, 5, 64, 64, 3)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and np.count_nonzero(d) / d.size < 0.01, (
        d.max(), np.count_nonzero(d) / d.size)


@pytest.mark.parametrize("k", [3, 5])
def test_streams_must_split_evenly(case, k):
    _, _, cfg, net, lr, _ = case
    with pytest.raises(ValueError, match="do not split over"):
        infer_streams(net, torch.from_numpy(lr), cfg, ["cpu"] * k, CHUNK)
