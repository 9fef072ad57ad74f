"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test decides inside whether a card is present and skips
without one. Run on the card with
  python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest
Tolerance rtol 2e-4 / atol 2e-5, the kernel tests' (fp32 sums in another
order, and with float atomics in an order that changes from run to run; the
time buckets must agree exactly, which bucket-boundary deltas in the inputs
would expose), rtol 5e-4 for the bias tables' gradients; counts exactly.
"""

import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import count_offsets as count_kern
from mygenerativerecommenders_tpu_torch.ops.kernels import dense_neg_lse as lse_kern
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,d", [(3, 37, 1, 9), (16, 211, 1, 50), (2, 300, 2, 64)])
def test_backward_kernel_matches_autograd_of_plain_on_card(b, n, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(1)
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_()
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    ts = torch.tensor(ts, dtype=torch.int32).cuda()
    pw = torch.tensor(rng.normal(size=(2 * n - 1,)) * 0.02, dtype=torch.float32).cuda()
    tw = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda()
    pw.requires_grad_(), tw.requires_grad_()
    lengths = torch.tensor(np.linspace(1, n, b).astype(np.int32)).cuda()
    # a non-contiguous upstream gradient, as a transposing consumer would send
    g = torch.tensor(rng.normal(size=(b, h, n, d)), dtype=torch.float32).cuda().transpose(1, 2)

    def grads(fn):
        _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
        out = fn(
            q.unflatten(-1, (h, d)), k.unflatten(-1, (h, d)), v.unflatten(-1, (h, d)),
            ts, pw, tw, n, 128, lengths,
        )
        return torch.autograd.grad(out, [proj, pw, tw], g)

    before = kern.bwd_launches
    got = grads(kern.hstu_attention_fused)
    torch.cuda.synchronize()
    assert kern.bwd_launches == before + 1
    want = grads(kern.hstu_attention_fused_plain)
    for i, (a, w) in enumerate(zip(got, want)):
        rtol = 2e-4 if i == 0 else 5e-4
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=2e-5)
    for i, length in enumerate(lengths.tolist()):
        assert not got[0][i, length:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("bt,r,x", [(100, 16, 200), (2000, 128, 3706), (64, 255, 26744)])
def test_count_kernel_equals_plain_on_card(bt, r, x):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(2)
    offsets = rng.integers(0, x, size=(bt, r)).astype(np.int32)
    positive = rng.integers(-1, x, size=bt).astype(np.int32)
    offsets[::3, :4] = positive[::3, None]  # accidental hits (or -1: dropped)
    offsets[-5:, r // 2 :] = x + 3  # sentinels
    o, p = torch.tensor(offsets).cuda(), torch.tensor(positive).cuda()
    before = count_kern.launches
    got = count_kern.count_offsets(o, p, x)
    torch.cuda.synchronize()
    assert count_kern.launches == before + 1
    assert torch.equal(got, count_kern.count_offsets_plain(o, p, x))


@pytest.mark.gpu
@pytest.mark.parametrize("bt,d,x", [(70, 12, 150), (1000, 50, 3706), (130, 128, 700)])
def test_dense_neg_lse_kernels_match_plain_on_card(bt, d, x):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    offsets = torch.tensor(rng.integers(0, x, size=(bt, 16)), dtype=torch.int32)
    positive = torch.tensor(rng.integers(-1, x, size=bt), dtype=torch.int32)
    positive[0] = 7
    offsets[0] = 7  # an all-hit row: lse -inf, no gradient
    count = count_kern.count_offsets(offsets.cuda(), positive.cuda(), x)
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()

    def run(fn):
        lse = fn(q, cat, count, 0.05)
        loss = (torch.where(torch.isfinite(lse), lse, 0.0) * gl).sum()
        return lse, torch.autograd.grad(loss, [q, cat])

    before = (lse_kern.launches, lse_kern.bwd_launches)
    lse, got = run(lse_kern.dense_neg_lse)
    torch.cuda.synchronize()
    assert (lse_kern.launches, lse_kern.bwd_launches) == (before[0] + 1, before[1] + 1)
    want_lse, want = run(lse_kern.dense_neg_lse_plain)
    assert lse[0] == -torch.inf and want_lse[0] == -torch.inf
    np.testing.assert_allclose(lse.detach().cpu().numpy(), want_lse.detach().cpu().numpy(), rtol=2e-4, atol=2e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-5)
    assert not got[0][0].any()


def _packed_layout(rng, b, n, max_seg):
    """Within-segment positions [b, n] and packed lengths [b]: segments of
    mixed lengths (1 and max_seg among them) laid end to end; row 0 keeps a
    padded tail (positions 0 there, as the loader leaves them)."""
    pos = np.zeros((b, n), dtype=np.int32)
    lengths = np.zeros(b, dtype=np.int32)
    for r in range(b):
        room = n - (n // 5 if r == 0 else 0)
        segs = [1, min(max_seg, room - 1)] if r == 1 else []
        while sum(segs) < room:
            segs.append(int(min(rng.integers(1, max_seg + 1), room - sum(segs))))
        at = 0
        for s in segs:
            pos[r, at : at + s] = np.arange(s)
            at += s
        lengths[r] = at
    return pos, lengths


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,n,h,d,max_len", [(3, 48, 2, 16, 40), (56, 256, 1, 50, 211), (2, 1152, 2, 64, 1035)]
)
def test_packed_attention_kernels_match_plain_on_card(b, n, h, d, max_len):
    """Forward and backward with seg_positions, rows wider than max_len
    included; a null seg_positions gives what the kernels gave without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(4)
    pos, lengths = _packed_layout(rng, b, n, min(max_len, n))
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_()
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    ts = torch.tensor(ts, dtype=torch.int32).cuda()
    pw = torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02, dtype=torch.float32).cuda()
    tw = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda()
    pw.requires_grad_(), tw.requires_grad_()
    seg, lens = torch.tensor(pos).cuda(), torch.tensor(lengths).cuda()
    g = torch.tensor(rng.normal(size=(b, n, h, d)), dtype=torch.float32).cuda()

    def run(fn, seg_positions):
        _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
        out = fn(
            q.unflatten(-1, (h, d)), k.unflatten(-1, (h, d)), v.unflatten(-1, (h, d)),
            ts, pw, tw, max_len, 128, lens, seg_positions,
        )
        return out, torch.autograd.grad(out, [proj, pw, tw], g)

    before = (kern.launches, kern.bwd_launches)
    got, got_grads = run(kern.hstu_attention_fused, seg)
    torch.cuda.synchronize()
    assert (kern.launches, kern.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, want_grads = run(kern.hstu_attention_fused_plain, seg)
    np.testing.assert_allclose(
        got.detach().cpu().numpy(), want.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
    )
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        rtol = 2e-4 if i == 0 else 5e-4
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=2e-5)
    for r, length in enumerate(lengths.tolist()):
        assert not got[r, length:].any() and not got_grads[0][r, length:].any()
    if n <= max_len:  # unpacked rows may not be wider than the table
        null, _ = run(kern.hstu_attention_fused, None)
        plain, _ = run(kern.hstu_attention_fused_plain, None)
        np.testing.assert_allclose(
            null.detach().cpu().numpy(), plain.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
        )


@pytest.mark.gpu
@pytest.mark.parametrize("bt,d,x", [(700, 64, 26744), (300, 50, 26744)])
def test_dense_neg_lse_kernels_match_plain_on_a_wide_catalog_on_card(bt, d, x):
    """The lse forward and backward over a catalog many tiles wide (the TPU
    package's multi-x-block kernels' function)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    offsets = torch.tensor(rng.integers(0, x, size=(bt, 128)), dtype=torch.int32)
    positive = torch.tensor(rng.integers(-1, x, size=bt), dtype=torch.int32)
    positive[0] = 7
    offsets[0] = 7  # an all-hit row: lse -inf, no gradient
    count = count_kern.count_offsets(offsets.cuda(), positive.cuda(), x)
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()

    def run(fn):
        lse = fn(q, cat, count, 0.05)
        loss = (torch.where(torch.isfinite(lse), lse, 0.0) * gl).sum()
        return lse, torch.autograd.grad(loss, [q, cat])

    lse, got = run(lse_kern.dense_neg_lse)
    want_lse, want = run(lse_kern.dense_neg_lse_plain)
    torch.cuda.synchronize()
    assert lse[0] == -torch.inf and want_lse[0] == -torch.inf
    np.testing.assert_allclose(
        lse.detach().cpu().numpy(), want_lse.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
    )
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-5)
    assert not got[0][0].any()
