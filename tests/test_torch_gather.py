"""The port's gather-sum (Queue 2 #5) against the JAX resolve-gather study.

``pallas_gather`` of androidrenderer_tpu_torch/tools/microbench_pallas_gather.py
launches the hand-written CUDA kernel csrc/gather.cu on the card; on the CPU it
runs the kernel's plain version. Here it runs against the JAX tool's
``pallas_gather`` (tools/microbench_pallas_gather.py) in Pallas interpret mode on
the tool's own ``--check`` input (a 64 x 32 table, one tile of 2048 indices),
made from a seed, at the tool's tolerance, rtol 2e-5
(microbench_pallas_gather.py:135): the TPU kernel sums in index order, the port
in another fixed order.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

_root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
for _p in (os.path.join(_root, "tools"), os.path.join(_root, "tools", "experiments")):
    if _p not in sys.path:
        sys.path.append(_p)

import microbench_pallas_gather as jax_tool  # noqa: E402  (tools/)

from androidrenderer_tpu_torch.ops.gather import (  # noqa: E402
    gather_tile_sums,
    gather_tile_sums_reference,
)
from androidrenderer_tpu_torch.tools import microbench_pallas_gather as tool  # noqa: E402

torch.set_num_threads(1)


def test_pallas_gather_matches_jax_kernel():
    table, idx = tool.make_inputs(64, 32, "cpu", lookups=tool.TILE, seed=3)
    want = np.asarray(jax_tool.pallas_gather(
        jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()), interpret=True))
    got = tool.pallas_gather(table, idx).numpy()
    assert got.shape == want.shape == (1, 8, 32)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert not got[:, 1:].any()


@pytest.mark.parametrize("width", [8, 32])
def test_plain_version_sums_each_tile(width):
    """Three tiles against a numpy sum of each tile's rows (float64)."""
    rng = np.random.default_rng(width)
    table = rng.random((1000, width), dtype=np.float32)
    idx = rng.integers(0, 1000, 3 * 2048).astype(np.int32)
    got = gather_tile_sums_reference(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    want = table.astype(np.float64)[idx].reshape(3, 2048, width).sum(1)
    assert got.shape == (3, 8, width)
    np.testing.assert_allclose(got[:, 0], want, rtol=2e-5)
    assert not got[:, 1:].any()


def test_wrapper_rules():
    """The CPU runs the plain version and counts no launch; timing stubs, other
    devices and inputs the kernel does not take raise."""
    table, idx = tool.make_inputs(64, 8, "cpu", lookups=2 * tool.TILE)
    before = gather_tile_sums.launches
    assert torch.equal(tool.pallas_gather(table, idx, interpret=True),
                       gather_tile_sums_reference(table, idx))
    assert gather_tile_sums.launches == before
    for mode in (1, 2):
        with pytest.raises(ValueError, match="debug_mode"):
            tool.pallas_gather(table, idx, debug_mode=mode)
    with pytest.raises(ValueError):
        gather_tile_sums(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError):
        gather_tile_sums(table, idx[:100])
    with pytest.raises(TypeError):
        gather_tile_sums(table, idx.long())
    with pytest.raises(TypeError):
        gather_tile_sums(table.double(), idx)


def test_tool_check_and_embedding_bag():
    """The tool's --check passes, and its yardstick (embedding_bag) computes the
    same tile sums."""
    tool.main(["--check"])
    table, idx = tool.make_inputs(256, 16, "cpu", lookups=2 * tool.TILE)
    np.testing.assert_allclose(tool.embedding_bag_sums(table, idx).numpy(),
                               gather_tile_sums(table, idx)[:, 0].numpy(), rtol=2e-5)
