"""The CUDA HSTU attention kernel against its plain PyTorch version, on the card.

Marked `gpu`: it decides inside the test whether a card is present and skips
without one. Run on the card with
  python -m pytest tests/test_torch_port_gpu.py -m gpu
Tolerance rtol 2e-4 / atol 2e-5, the kernel tests' (fp32 sums in another
order; the time buckets must agree exactly, which bucket-boundary deltas in
the inputs would expose).
"""

import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_attention as kern


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,dqk,dv", [(3, 37, 1, 9, 11), (32, 211, 1, 50, 50), (2, 300, 2, 64, 64)])
def test_kernel_matches_plain_on_card(b, n, h, dqk, dv):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(0)
    # q, k, v as column slices of one projection, as the HSTU block hands them over
    proj = torch.tensor(rng.normal(size=(b, n, 2 * h * dqk + h * dv)), dtype=torch.float32)
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    pos_w = torch.tensor(rng.normal(size=(2 * n - 1,)) * 0.02, dtype=torch.float32)
    ts_w = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32)
    lengths = torch.tensor(np.linspace(1, n, b).astype(np.int32))
    args = [proj.cuda(), torch.tensor(ts, dtype=torch.int32).cuda(), pos_w.cuda(), ts_w.cuda()]
    p, ts_c, pw, tw = args
    q = p[..., : h * dqk].unflatten(-1, (h, dqk))
    k = p[..., h * dqk : 2 * h * dqk].unflatten(-1, (h, dqk))
    v = p[..., 2 * h * dqk :].unflatten(-1, (h, dv))
    before = kern.launches
    got = kern.hstu_attention_fused(q, k, v, ts_c, pw, tw, n, 128, lengths=lengths.cuda())
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = kern.hstu_attention_fused_plain(q, k, v, ts_c, pw, tw, n, 128, lengths.cuda())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-5)
    for i, length in enumerate(lengths.tolist()):
        assert not got[i, length:].any()
