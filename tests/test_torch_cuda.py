"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on a CUDA card.

The kernels have no CPU mode: without a card these tests skip with a
reason. On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only the port is installed.
"""

import pytest
import torch

from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.ops import reduce_kernel, sweep_kernel, table_kernel
from gbp_poplar_tpu_torch.utils import balio


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_kernels_match_plain_on_card(cuda_device, name):
    prob = (balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                    pixel_noise=0.5) if name == "pinhole"
            else balio.synthetic_problem_snavely(pixel_noise=0.5))
    cfg = GBPConfig(accel_every=0)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 20, with_diagnostics=False)
    for d, bel in ((6, s.cam_bel), (3, s.lmk_bel)):
        k = table_kernel.build_table(bel, d)
        r = table_kernel.build_table(bel, d, reference=True)
        torch.testing.assert_close(k, r, rtol=1e-5, atol=0)
    sk, sr = s.clone(), s.clone()
    ct = table_kernel.build_table(s.cam_bel, 6, reference=True)
    lt = table_kernel.build_table(s.lmk_bel, 3, reference=True)
    sweep_kernel.sweep(sk, g, ct, lt, cfg)
    sweep_kernel.sweep(sr, g, ct, lt, cfg, reference=True)
    assert torch.equal(sk.damping_count, sr.damping_count)
    assert torch.equal(sk.robust, sr.robust)
    torch.testing.assert_close(sk.pk, sr.pk, rtol=1e-4, atol=1e-4)
    for rows, seg, prior in ((sk.pk[54:81], g.cam_seg, sk.cam_prior),
                             (sk.pk[81:90], g.lmk_seg, sk.lmk_prior)):
        k = reduce_kernel.segment_sum(rows, seg, prior)
        r = reduce_kernel.segment_sum(rows, seg, prior, reference=True)
        # the plain version adds with atomics in a run-dependent order:
        # bound the difference by 1e-5 of the sum of |terms|
        scale = reduce_kernel.segment_sum(rows.abs(), seg, prior.abs(),
                                          reference=True)
        assert bool(((k - r).abs() <= 1e-5 * scale).all())
        assert torch.equal(k, reduce_kernel.segment_sum(rows, seg, prior))
