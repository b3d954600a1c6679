"""Render golden cases with the JAX frame run op by op (``jax.disable_jit``)
and with the port on the CPU, and print how each compares with the committed
golden and with the other. Not a test (pytest does not collect it): one case
takes the JAX side one to three minutes.

    JAX_PLATFORMS=cpu python tests/compare_goldens_eager.py cornell_direct cornell_lpv
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import make_goldens  # noqa: E402
from androidrenderer_tpu_torch.tools import golden_cases  # noqa: E402
from androidrenderer_tpu_torch.utils.image import ssim  # noqa: E402


def main(names):
    for name in names or golden_cases.CASES:
        with jax.disable_jit():
            eager = np.asarray(make_goldens.CASES[name]())
        port, _ = golden_cases.CASES[name]("cpu")
        gold = golden_cases.golden(name)
        diff = np.abs(port.astype(int) - eager.astype(int)).max(axis=-1)
        print(f"{name}: SSIM against the golden, JAX op by op {ssim(eager, gold):.5f}, the port "
              f"{ssim(port, gold):.5f}; pixels where the port differs from JAX op by op: "
              f"{int((diff > 0).sum())} (largest step {int(diff.max())})")


if __name__ == "__main__":
    main(sys.argv[1:])
