"""The CUDA kernels against their plain PyTorch versions, and the graphed
train step (a CUDA graph replay) against the eager one, on the card.

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
from mygenerativerecommenders_tpu_torch.ops.kernels import hstu_chunk as chunk_kern


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
    lengths = np.linspace(1, n, b).astype(np.int32)
    if dqk != dv:
        lengths[1] = 0  # an empty row: written as exact zeros
    lengths = torch.tensor(lengths)
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
    # each output is written once, without atomics: the same bits every call
    again = kern.hstu_attention_fused(q, k, v, ts_c, pw, tw, n, 128, lengths=lengths.cuda())
    assert torch.equal(again, got)


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
    # dq, dk and dv (proj's gradient) take no atomics: the same bits every call
    assert torch.equal(grads(kern.hstu_attention_fused)[0], got[0])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "bt,r,x",
    [(37, r, x) for r in (16, 300) for x in (1, 15, 17, 3706, 26744)]
    + [(100, 16, 200), (2000, 128, 3706), (64, 255, 26744), (64, 256, 26744), (300, 300, 3706)],
)
def test_count_kernel_equals_plain_on_card(bt, r, x):
    """uint8 (r <= 255) and int32 counts; 37 rows start at every offset from
    a 16-byte boundary that X gives them, and X = 1, 15, 17 hold less than
    one 16-byte store a row, or one and a bit."""
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
    assert got.dtype == (torch.uint8 if r <= 255 else torch.int32)
    assert torch.equal(got, count_kern.count_offsets_plain(o, p, x))


def _check_lse_forward(q, cat, count, lse, sup_off=None):
    """The forward kernel's (m_safe, s) against the sparse plain forward; lse
    the same bits in a second call."""
    q, cat = q.detach(), cat.detach()
    again, m_safe, s = lse_kern.dense_neg_lse_stats(q, cat, count, 0.05, sup_off)
    want = lse_kern.dense_neg_lse_stats_sparse_plain(q, cat, count, 0.05, sup_off)
    for a, w in zip((m_safe, s), want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-5)
    assert torch.equal(again, lse.detach())


def _check_lse_backward(q, cat, count, lse, gl, got, sup_off=None, stats_count=None):
    """The backward kernel's dq, dcat against the sparse plain backward, given
    the plain forward's (m_safe, s); dq the same bits in a second call."""
    gl = torch.where(torch.isfinite(lse), gl, 0.0).detach()
    m_safe, s = lse_kern.dense_neg_lse_stats_plain(
        q.detach(), cat.detach(), count if stats_count is None else stats_count, 0.05)
    want = lse_kern.dense_neg_lse_bwd_plain(q.detach(), cat.detach(), count, m_safe, s, gl, 0.05,
                                            sup_off)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-5)
    assert torch.equal(torch.autograd.grad(lse, [q], gl, retain_graph=True)[0], got[0])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "bt,d,x,r", [(70, 12, 150, 16), (1000, 50, 3706, 16), (130, 128, 700, 16),
                 (1000, 50, 3706, 256), (130, 64, 700, 300), (1000, 64, 150, 255),
                 (1000, 130, 3883, 128), (1000, 192, 3883, 128), (1000, 256, 3883, 128),
                 (300, 520, 3883, 128), (300, 256, 3883, 300)]
)
def test_dense_neg_lse_kernels_match_plain_on_card(bt, d, x, r):
    """r > 255 draws a row: int32 counts, some of them above 255. 255 draws
    into 150 columns: rows with more live logits than the kernels list at
    once. D above 128: the 256-column slices (one slice at 130, 192 and 256,
    three at 520). The forward's m_safe and s against the sparse plain
    forward; lse and dq take no atomics: the same bits in a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    offsets = torch.tensor(rng.integers(0, x, size=(bt, r)), dtype=torch.int32)
    offsets[1] = 3  # every draw of row 1 on one item
    positive = torch.tensor(rng.integers(-1, x, size=bt), dtype=torch.int32)
    positive[0] = 7
    offsets[0] = 7  # an all-hit row: lse -inf, no gradient
    positive[1] = -1
    count = count_kern.count_offsets(offsets.cuda(), positive.cuda(), x)
    assert int(count[1, 3]) == r
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()

    def run(fn):
        lse = fn(q, cat, count, 0.05)
        loss = (torch.where(torch.isfinite(lse), lse, 0.0) * gl).sum()
        return lse, torch.autograd.grad(loss, [q, cat], retain_graph=True)

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
    _check_lse_forward(q, cat, count, lse)
    _check_lse_backward(q, cat, count, lse, gl, got)


@pytest.mark.gpu
def test_dense_neg_lse_dcat_is_the_float64_sum_on_dense_rows():
    """255 draws into 150 columns over 4,096 rows: each dcat entry sums some
    3,300 terms that mostly cancel, where two float32 orders part by most of
    rtol 2e-4 / atol 2e-5. The kernel sums them in float64: held against the
    whole function in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    bt, d, x, r = 4096, 64, 150, 255
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    offsets = torch.tensor(rng.integers(0, x, size=(bt, r)), dtype=torch.int32).cuda()
    positive = torch.tensor(rng.integers(-1, x, size=bt), dtype=torch.int32).cuda()
    count = count_kern.count_offsets(offsets, positive, x)
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()
    lse = lse_kern.dense_neg_lse(q, cat, count, 0.05)
    assert torch.isfinite(lse).all()
    dcat = torch.autograd.grad(lse, [cat], gl)[0]
    q64, cat64 = q.detach().double(), cat.detach().double()
    al = torch.where(count > 0, q64 @ cat64.T / 0.05, -torch.inf)
    p = count.double() * torch.exp(al - al.max(dim=-1, keepdim=True).values)
    want = (p / p.sum(dim=-1, keepdim=True) * gl.double()[:, None] / 0.05).T @ q64
    np.testing.assert_allclose(dcat.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-5)


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
    "b,n,h,d,max_len",
    [(3, 48, 2, 16, 40), (56, 256, 1, 50, 211), (2, 1152, 2, 64, 1035), (4, 1121, 2, 64, 1035)],
)
def test_packed_attention_kernels_match_plain_on_card(b, n, h, d, max_len):
    """Forward and backward with seg_positions, rows wider than max_len
    included; a null seg_positions gives what the kernels gave without it.
    The 4-row case has N off the backward's 32-row tile and packed lengths
    of 1 and 20 (less than a tile) in rows 2 and 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(4)
    pos, lengths = _packed_layout(rng, b, n, min(max_len, n))
    if b == 4:
        pos[2], pos[3] = 0, np.where(np.arange(n) < 20, np.arange(n), 0)
        lengths[2], lengths[3] = 1, 20
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
    # the output and dq, dk, dv take no atomics: the same bits every call
    out_again, grads_again = run(kern.hstu_attention_fused, seg)
    assert torch.equal(out_again, got)
    assert torch.equal(grads_again[0], got_grads[0])
    if n <= max_len:  # unpacked rows may not be wider than the table
        null, _ = run(kern.hstu_attention_fused, None)
        plain, _ = run(kern.hstu_attention_fused_plain, None)
        np.testing.assert_allclose(
            null.detach().cpu().numpy(), plain.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
        )


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dqk,dv", [(130, 130), (192, 192), (256, 256), (64, 192), (300, 72)])
def test_wide_attention_kernels_match_plain_on_card(dqk, dv, packed):
    """Heads wider than 128 (the wide kernels of csrc/hstu_attention_fwd.cu
    and _bwd.cu: depth in 128-column slices, one 128-column slice of each
    output a block), padded (B=16, N=L=211, ragged, an empty row) and packed
    (B=8, N=256, L=211): output and gradients against the plain version, one
    launch each, rows past the length zero, the output and dq, dk, dv the
    same bits in a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(dqk + dv)
    b, n, max_len, h = (8, 256, 211, 1) if packed else (16, 211, 211, 1)
    if packed:
        pos, lengths = _packed_layout(rng, b, n, max_len)
        seg = torch.tensor(pos).cuda()
    else:
        lengths = np.linspace(1, n, b).astype(np.int32)
        lengths[2] = 0
        seg = None
    proj = torch.tensor(rng.normal(size=(b, n, 2 * h * (dqk + dv))), dtype=torch.float32).cuda()
    proj.requires_grad_()
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    ts = torch.tensor(ts, dtype=torch.int32).cuda()
    pw = torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02, dtype=torch.float32).cuda()
    tw = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda()
    pw.requires_grad_(), tw.requires_grad_()
    lens = torch.tensor(lengths).cuda()
    g = torch.tensor(rng.normal(size=(b, n, h, dv)), dtype=torch.float32).cuda()

    def run(fn):
        _, v, q, k = torch.split(proj, [h * dv, h * dv, h * dqk, h * dqk], dim=-1)
        out = fn(q.unflatten(-1, (h, dqk)), k.unflatten(-1, (h, dqk)), v.unflatten(-1, (h, dv)),
                 ts, pw, tw, max_len, 128, lens, seg)
        return out, torch.autograd.grad(out, [proj, pw, tw], g)

    before = (kern.launches, kern.bwd_launches)
    got, got_grads = run(kern.hstu_attention_fused)
    torch.cuda.synchronize()
    assert (kern.launches, kern.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, want_grads = run(kern.hstu_attention_fused_plain)
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().cpu().numpy(),
                               rtol=2e-4, atol=2e-5)
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4 if i == 0 else 5e-4,
                                   atol=2e-5)
    for r, length in enumerate(lengths.tolist()):
        assert not got[r, length:].any() and not got_grads[0][r, length:].any()
    out_again, grads_again = run(kern.hstu_attention_fused)
    assert torch.equal(out_again, got) and torch.equal(grads_again[0], got_grads[0])


@pytest.mark.gpu
def test_attention_kernels_match_plain_at_the_ranking_shape_on_card():
    """The ranking task's rows: N = 2 x 211 = 422 item and rating tokens (off
    the 64-key tile), each timestamp on the two tokens of a pair (a zero
    gap), a table of 843 entries, even lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(6)
    b, n, h, d = 16, 422, 1, 50
    proj = torch.tensor(rng.normal(size=(b, n, 4 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_()
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n // 2)), axis=1)
    ts = torch.tensor(np.repeat(ts, 2, axis=1), dtype=torch.int32).cuda()
    pw = torch.tensor(rng.normal(size=(2 * n - 1,)) * 0.02, dtype=torch.float32).cuda()
    tw = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda()
    pw.requires_grad_(), tw.requires_grad_()
    lengths = torch.tensor(2 * np.linspace(1, n // 2, b).astype(np.int32)).cuda()
    g = torch.tensor(rng.normal(size=(b, n, h, d)), dtype=torch.float32).cuda()

    def run(fn):
        _, v, q, k = torch.split(proj, [h * d] * 4, dim=-1)
        out = fn(q.unflatten(-1, (h, d)), k.unflatten(-1, (h, d)), v.unflatten(-1, (h, d)),
                 ts, pw, tw, n, 128, lengths)
        return out, torch.autograd.grad(out, [proj, pw, tw], g)

    before = (kern.launches, kern.bwd_launches)
    got, got_grads = run(kern.hstu_attention_fused)
    torch.cuda.synchronize()
    assert (kern.launches, kern.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, want_grads = run(kern.hstu_attention_fused_plain)
    np.testing.assert_allclose(
        got.detach().cpu().numpy(), want.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
    )
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        rtol = 2e-4 if i == 0 else 5e-4
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=2e-5)
    for r, length in enumerate(lengths.tolist()):
        assert not got[r, length:].any() and not got_grads[0][r, length:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("bt,d,x", [(700, 64, 26744), (300, 50, 26744), (4297, 64, 26744)])
def test_dense_neg_lse_kernels_match_plain_on_a_wide_catalog_on_card(bt, d, x):
    """The lse forward and backward over a catalog many tiles wide (the TPU
    package's multi-x-block kernels' function); 4,297 rows are the 256-token
    class of a packed ml-20m-hstu-long step."""
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
        return lse, torch.autograd.grad(loss, [q, cat], retain_graph=True)

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
    _check_lse_forward(q, cat, count, lse)
    _check_lse_backward(q, cat, count, lse, gl, got)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,nq,nc,h,d,offd,max_len",
    [
        (3, 37, 50, 1, 9, -50, 100),  # fully live, Nq != Nc
        (32, 130, 130, 2, 64, 0, 1035),  # the zigzag ring's diagonal chunk
        (4, 259, 259, 2, 64, 100, 1035),  # partial
        (2, 40, 70, 2, 16, 40, 100),  # dead: zeros
        (2, 130, 130, 2, 64, -910, 1035),  # padded rows past the table: clipped slot
        (4, 259, 259, 2, 64, -259, 1035),  # the contiguous ring's fully live chunk
        (3, 45, 70, 2, 64, 10, 100),  # Nq off the 32-row tile, Nq != Nc, partial
    ],
    ids=["negative", "zero", "partial", "dead", "off-table", "full-259", "ragged-partial"],
)
def test_chunk_kernels_match_plain_on_card(b, nq, nc, h, d, offd, max_len):
    """Chunk forward and backward against autograd of the plain version, q, k,
    v read as strided slices of one projection (as the ring hands them over).
    Both kernels write their outputs whole without atomics: the forward's
    output and dq, dk, dv are bit-identical in a second call, and key rows no
    live pair reaches are exactly zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(6)
    n = nq + nc
    proj = torch.tensor(rng.normal(size=(b, n, 3 * h * d)), dtype=torch.float32).cuda()
    proj.requires_grad_()
    ts = np.sort(978_000_000 + rng.integers(0, 3 * 365 * 86400, size=(b, n)), axis=1)
    ts = torch.tensor(ts, dtype=torch.int32).cuda()
    pw = torch.tensor(rng.normal(size=(2 * max_len - 1,)) * 0.02, dtype=torch.float32).cuda()
    tw = torch.tensor(rng.normal(size=(129,)) * 0.02, dtype=torch.float32).cuda()
    pw.requires_grad_(), tw.requires_grad_()
    g = torch.tensor(rng.normal(size=(b, nq, h, d)), dtype=torch.float32).cuda()

    def run(fn):
        q, k, v = (x.unflatten(-1, (h, d)) for x in torch.split(proj, [h * d] * 3, dim=-1))
        out = fn(q[:, :nq], k[:, nq:], v[:, nq:], ts[:, :nq], ts[:, nq:], offd, pw, tw,
                 inv_n=1.0 / max_len, max_len=max_len, num_buckets=128)
        return out, torch.autograd.grad(out, [proj, pw, tw], g)

    before = (chunk_kern.launches, chunk_kern.bwd_launches)
    got, got_grads = run(chunk_kern.hstu_chunk_attention)
    torch.cuda.synchronize()
    assert (chunk_kern.launches, chunk_kern.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, want_grads = run(chunk_kern.hstu_chunk_attention_plain)
    np.testing.assert_allclose(
        got.detach().cpu().numpy(), want.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
    )
    for i, (a, w) in enumerate(zip(got_grads, want_grads)):
        rtol = 2e-4 if i == 0 else 5e-4
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=rtol, atol=2e-5)
    if offd >= nq:
        assert not got.any() and not any(x.any() for x in got_grads)
    # key rows m >= nq - offd see no query row (proj rows nq + m hold only dk, dv)
    assert not got_grads[0][:, nq + min(max(nq - offd, 0), nc):].any()
    out_again, again = run(chunk_kern.hstu_chunk_attention)
    assert torch.equal(out_again, got)
    assert torch.equal(again[0], got_grads[0])


@pytest.mark.gpu
@pytest.mark.parametrize("bt,d,x,padded", [(70, 12, 150, True), (700, 64, 26744, False)])
def test_fused_dense_neg_lse_with_and_without_sup_off_on_card(bt, d, x, padded):
    """The lse kernels with sup_off against the plain version, the forward's
    m_safe and s against the sparse plain forward, lse the same bits in a
    second call; an all -1 sup_off gives the bits of the training path's null
    pointer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.normal(size=(bt, d)), dtype=torch.float32)
    cat = torch.tensor(rng.normal(size=(x, d)), dtype=torch.float32)
    q = (q / q.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    cat = (cat / cat.norm(dim=-1, keepdim=True)).cuda().requires_grad_()
    width = -(-x // 128) * 128 if padded else x
    count = torch.zeros((bt, width), dtype=torch.uint8)
    draws = torch.tensor(rng.integers(0, x, size=(bt, 32)), dtype=torch.long)
    count.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.uint8))
    sup = torch.tensor(np.where(rng.random(bt) < 0.2, -1, draws[:, 0].numpy()), dtype=torch.int32)
    count[0] = 0
    count[0, 7] = 2
    sup[0] = 7  # an all-hit row: lse -inf, no gradient
    count, sup = count.cuda(), sup.cuda()
    gl = torch.tensor(rng.normal(size=(bt,)), dtype=torch.float32).cuda()

    def run(fn, s):
        lse = fn(q, cat, count, s, 0.05)
        loss = (torch.where(torch.isfinite(lse), lse, 0.0) * gl).sum()
        return lse, torch.autograd.grad(loss, [q, cat], retain_graph=True)

    before = (lse_kern.fused_launches, lse_kern.fused_bwd_launches)
    lse, got = run(lse_kern.fused_dense_neg_lse, sup)
    torch.cuda.synchronize()
    assert (lse_kern.fused_launches, lse_kern.fused_bwd_launches) == (before[0] + 1, before[1] + 1)
    want_lse, want = run(lse_kern.fused_dense_neg_lse_plain, sup)
    assert lse[0] == -torch.inf and want_lse[0] == -torch.inf
    np.testing.assert_allclose(
        lse.detach().cpu().numpy(), want_lse.detach().cpu().numpy(), rtol=2e-4, atol=2e-5
    )
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(), rtol=2e-4, atol=2e-5)
    assert not got[0][0].any()
    no_hits = count[:, :x].clone()
    live = sup >= 0
    no_hits[torch.arange(bt, device="cuda")[live], sup[live].long()] = 0
    _check_lse_forward(q, cat, count, lse, sup)
    _check_lse_backward(q, cat, count, lse, gl, got, sup, no_hits)
    # all -1 masks nothing: the null pointer's lse and dq to the bit
    none = torch.full_like(sup, -1)
    masked, masked_grads = run(lse_kern.fused_dense_neg_lse, none)
    null = lse_kern.dense_neg_lse(q, cat, count[:, :x].contiguous(), 0.05)
    null_dq = torch.autograd.grad(
        (torch.where(torch.isfinite(null), null, 0.0) * gl).sum(), [q])[0]
    assert torch.equal(masked, null) and torch.equal(masked_grads[0], null_dq)


# ---------------------------------------------------------------- CUDA graphs
# trainer.steps_per_call > 1 replays a CUDA graph of the whole step
# (train/graphs.py); 1 runs it eagerly. Both use the fused AdamW and draw the
# negatives from the trainer's generator and dropout from the default one, so
# the two follow one stream (Muon and Scion as well: a tensor rate each, no
# host sync in Newton-Schulz). The kernels sum in the same order in both, but
# the attention backward adds its bias-table gradients with float atomics:
# the loss at rtol 1e-5 and the parameters at rtol 5e-4 / atol 1e-6, the
# tolerances of chip_smoke.py's card-vs-CPU step.

_GRAPH_CASES = {
    "padded": [],
    # the fused SGD with momentum and a tensor learning rate
    "padded-sgd": ["optimizer1.kind=sgd", "optimizer1.momentum=0.9", "optimizer1.lr=0.05"],
    "packed": ["data.pack_sequences=true", "data.pack_eval=true"],
    "ring": ["model.encoder.sp_shards=4", "model.encoder.sp_zigzag=true"],
    # the ranking step binds no negatives' buffer
    "ranking": ["experiment=synthetic-rank-smoke"],
    "ranking-packed": ["experiment=synthetic-rank-smoke", "data.pack_sequences=true"],
    # the per-sample gather loss; shared negatives ([R] offsets) with the
    # lazy table update, whose moments the capture's warm-up must leave as
    # they were
    "gather": ["model.loss.dense_catalog_negatives=false"],
    "lazy": ["model.loss.shared_negatives=true", "model.embedding.lazy_update=true"],
    "lazy-packed": ["model.loss.shared_negatives=true", "model.embedding.lazy_update=true",
                    "data.pack_sequences=true"],
    # the two-optimizer split: AdamW beside Muon / Scion (bfloat16
    # Newton-Schulz, a tensor rate each), whose momentum the warm-up creates
    # and the capture's restore zeroes; Muon over every parameter; and the
    # lazy table update beside the split
    "muon": ["optimizer2.enabled=true", "optimizer2.kind=muon", "optimizer2.lr=5e-3",
             "optimizer2.weight_decay=0.0", "scheduler2.kind=plateau"],
    "scion": ["optimizer2.enabled=true", "optimizer2.kind=scion", "optimizer2.lr=1e-3",
              "optimizer2.momentum=0.1", "scheduler2.kind=plateau"],
    "muon-single": ["optimizer1.kind=muon", "optimizer1.lr=5e-3"],
    "scion-light-single": ["optimizer1.kind=scion_light", "optimizer1.lr=1e-3"],
    "scion-init": ["optimizer2.enabled=true", "optimizer2.kind=scion", "optimizer2.lr=1e-3",
                   "optimizer2.scion_init=true"],
    "lazy-muon": ["model.loss.shared_negatives=true", "model.embedding.lazy_update=true",
                  "optimizer2.enabled=true", "optimizer2.kind=muon", "optimizer2.lr=5e-3"],
    # the aux user token, SASRec (its attention dropout one [N, N] mask a
    # block, from the default generator the capture restores), the in-batch
    # sampler (its uniforms drawn outside the graph; the pool's count stays
    # on the card), padded and packed, and BCE
    "aux": ["experiment=synthetic-aux-smoke"],
    "sasrec": ["model.encoder.kind=sasrec"],
    "in-batch": ["model.sampler.kind=in_batch"],
    "in-batch-packed": ["model.sampler.kind=in_batch", "data.pack_sequences=true"],
    "bce": ["model.loss.kind=bce"],
    # the item/year split table, MoL on the gather loss (padded and packed),
    # the softmax attention, the LayerNorm postprocessor, and Muon on SASRec's
    # 3-D kernels
    "item-year": ["model.embedding.kind=item_year"],
    "mol": ["model.similarity.kind=mol"],
    "mol-packed": ["model.similarity.kind=mol", "data.pack_sequences=true"],
    "softmax-rel-bias": ["model.encoder.normalization=softmax_rel_bias"],
    "layer-norm": ["model.postprocessor.kind=layer_norm"],
    "sasrec-muon": ["model.encoder.kind=sasrec", "optimizer2.enabled=true",
                    "optimizer2.kind=muon", "optimizer2.lr=5e-3"],
    # per-block remat: each block's recompute (with its forward's dropout
    # mask, checkpoint's stashed RNG state) inside the one replay; padded,
    # packed, and both ring layouts through the chunk kernels
    "remat": ["model.encoder.remat=true"],
    "remat-packed": ["model.encoder.remat=true", "data.pack_sequences=true"],
    "remat-ring": ["model.encoder.remat=true", "model.encoder.sp_shards=4",
                   "model.encoder.sp_zigzag=true"],
    "remat-ring-contiguous": ["model.encoder.remat=true", "model.encoder.sp_shards=4"],
    # compute_dtype=bfloat16 (its rounding points and their backward inside
    # the replay), padded and packed; a 256-wide head and lse (the wide kernels)
    "bfloat16": ["model.compute_dtype=bfloat16"],
    "bfloat16-packed": ["model.compute_dtype=bfloat16", "data.pack_sequences=true"],
    "wide-256": ["model.item_embedding_dim=256"],
}
# one step for the bfloat16 Newton-Schulz cases: from the second step on the
# bias tables' float atomics (which differ run to run, eager against eager)
# reach the matrices' gradients, and NS-5 in bfloat16 turns that float noise
# into bfloat16 ulps of their updates; so do the bfloat16 rounding points of
# compute_dtype=bfloat16
_ONE_STEP = {"muon", "scion", "muon-single", "scion-light-single", "scion-init", "lazy-muon",
             "sasrec-muon", "bfloat16", "bfloat16-packed"}


def _card_trainer(tmp_path, case, k, *extra):
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer

    return Trainer(cli_train.parse_args([
        "experiment=synthetic-smoke", f"trainer.output_dir={tmp_path / f'{case}{k}'}",
        f"trainer.steps_per_call={k}", *_GRAPH_CASES[case], *extra,
    ]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_GRAPH_CASES))
def test_graphed_steps_follow_the_eager_steps_on_card(tmp_path, case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.train import graphs

    packed = case.endswith("packed")
    steps = 1 if case in _ONE_STEP else 3
    runs = []
    for k in (1, 3):
        trainer = _card_trainer(tmp_path, case, k)
        trainer.model.train()  # dropout 0.2 on
        batches = [trainer._put(b) for _, b in zip(range(steps), trainer._loader("train", packed))]
        torch.manual_seed(11)
        if k == 1:
            losses = torch.stack([trainer.train_step(b, trainer.lr1) for b in batches])
        else:
            graphs.counts.clear()
            before = [getattr(m, a) for m, a in graphs._COUNTERS]
            losses = trainer.train_steps(batches, trainer.lr1)
            torch.cuda.synchronize()
            made = [getattr(m, a) - b for (m, a), b in zip(graphs._COUNTERS, before)]
            got = dict(graphs.counts["train"])
            assert got == {"captures": 1, "warmup_runs": graphs.WARMUP_RUNS,
                           "replays": steps}, got
            # every launch counted: the warm-up runs' own, and each replay's
            # the launches the capture recorded
            assert sum(made) > 0 and all(m % (graphs.WARMUP_RUNS + steps) == 0 for m in made)
        runs.append((losses.cpu().numpy(), {n: p.detach().cpu() for n, p in
                                           trainer.model.named_parameters()}))
        if case.startswith("lazy"):
            runs[-1][1]["mv"] = trainer.optimizer.mv.detach().cpu()
            runs[-1][1]["count"] = trainer.optimizer.count.cpu()
    (eager, p_eager), (graphed, p_graphed) = runs
    np.testing.assert_allclose(graphed, eager, rtol=1e-5)
    for name, want in p_eager.items():
        np.testing.assert_allclose(p_graphed[name].numpy(), want.numpy(), rtol=5e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["padded", "packed", "ring"])
def test_graphed_remat_step_gives_the_graphed_gradients_without_remat_on_card(tmp_path, case):
    """One graphed step with and without remat from the same weights, batch,
    negatives and dropout seed (0.2): the loss and every gradient at rtol
    1e-5 / atol 1e-6 (JAX tests/test_remat.py:52); the remat step launches
    the attention forward twice a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.train import graphs

    runs = []
    for remat in ("false", "true"):
        trainer = _card_trainer(tmp_path / remat, case, 2, f"model.encoder.remat={remat}")
        trainer.model.train()
        batch = trainer._put(next(iter(trainer._loader("train", case == "packed"))))
        torch.manual_seed(11)
        graphs.counts.clear()
        before = (kern.launches, chunk_kern.launches)
        loss = trainer.train_steps([batch], trainer.lr1)
        torch.cuda.synchronize()
        forwards = (kern.launches - before[0]) + (chunk_kern.launches - before[1])
        # the capture's warm-up runs and the replay
        forwards //= graphs.WARMUP_RUNS + 1
        runs.append((loss.cpu().numpy(), forwards,
                     {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()}))
    (want_loss, want_fwd, want), (got_loss, got_fwd, got) = runs
    assert got_fwd == 2 * want_fwd > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.gpu
def test_async_save_under_graph_replays_writes_the_state_of_its_call_on_card(tmp_path,
                                                                              monkeypatch):
    """An async save between graphed steps: the replays that follow update the
    parameters and moments in place while the write waits, and the file holds
    the state of the save's call, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    import threading

    from mygenerativerecommenders_tpu_torch.checkpoint import CheckpointManager

    gate = threading.Event()
    save = torch.save

    def held(obj, f, *args, **kwargs):
        if threading.current_thread().name == "checkpoint-writer":
            assert gate.wait(60)
        save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", held)
    trainer = _card_trainer(tmp_path, "remat", 2, "trainer.async_checkpoint=true")
    trainer.model.train()
    batches = [trainer._put(b) for _, b in zip(range(4), trainer._loader("train"))]
    trainer.train_steps(batches[:2], trainer.lr1)
    want_model = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    want_moments = [trainer.optimizer.state[p]["exp_avg"].cpu().clone()
                    for p in trainer.model.parameters()]
    trainer.ckpt.save(trainer.model, trainer.optimizer, step=2, epoch=0, metric_value=0.0)
    trainer.train_steps(batches[2:], trainer.lr1)  # replays while the write waits
    torch.cuda.synchronize()
    gate.set()
    trainer.ckpt.flush()
    saved = CheckpointManager.load(trainer.ckpt.last_path)
    moved = False
    for key, want in want_model.items():
        assert torch.equal(saved["model"][key], want), key
        moved |= not torch.equal(trainer.model.state_dict()[key].cpu(), want)
    assert moved
    for i, want in enumerate(want_moments):
        assert torch.equal(saved["optimizer"]["state"][i]["exp_avg"], want)


@pytest.mark.gpu
def test_resume_after_graphed_steps_gives_the_uninterrupted_losses_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    import json

    def losses(trainer, epoch):
        path = trainer.out_dir + "/metrics.jsonl"
        rows = [json.loads(line) for line in open(path).read().splitlines()]
        return [r["train/loss"] for r in rows if "train/loss" in r and r["epoch"] == epoch]

    extra = ["trainer.log_every_n_steps=1", "trainer.max_epochs=2"]
    whole = _card_trainer(tmp_path / "whole", "padded", 2, *extra)
    whole.fit()
    _card_trainer(tmp_path / "cut", "padded", 2, *extra[:1], "trainer.max_epochs=1").fit()
    last = tmp_path / "cut" / "padded2" / "synthetic-smoke" / "checkpoints" / "last.pt"
    resumed = _card_trainer(tmp_path / "cut", "padded", 2, *extra, f"trainer.ckpt_path={last}")
    resumed.fit()
    want, got = losses(whole, 1), losses(resumed, 1)
    assert len(got) == len(want) == 4  # one loss a call of two steps
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.gpu
def test_a_failed_capture_raises_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.train.graphs import StepGraphs

    def body(inputs):  # reading a value back to the host cannot be captured
        return (inputs["x"] * float(inputs["x"].sum()),)

    with pytest.raises(RuntimeError):
        StepGraphs(body, "test")({"x": torch.ones(4, device="cuda")})
    torch.cuda.synchronize()
    assert float(torch.ones(3, device="cuda").sum()) == 3.0  # the card still works


def _card_engines(tmp_path):
    """A graphed and an eager engine on the card over one synthetic-smoke
    model, and requests: ragged rows, some with timestamps."""
    from mygenerativerecommenders_tpu_torch.cli.train import parse_args
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.catalog import load_catalog
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine

    cfg = parse_args(["experiment=synthetic-smoke", f"data.data_dir={tmp_path}"])
    ids, max_id = load_catalog(cfg.data)
    resolve(cfg, max_id)
    model = build_model(cfg, device="cuda", seed=3)
    graphed, eager = (
        ServingEngine(model, cfg, ids, max_id, batch_size=8, device="cuda", graphs=g)
        for g in (True, False)
    )
    rng = np.random.default_rng(4)
    seqs = [rng.choice(ids, size=int(n)).tolist() for n in (1, 5, 30, 80)]
    stamps = [np.sort(978_000_000 + rng.integers(0, 10**7, size=len(s))).tolist() for s in seqs]
    stamps[1] = None
    return graphed, eager, seqs, stamps


_GENERATE = {"greedy": {}, "sample": dict(seed=3, temperature=0.7, top_k=20, top_p=0.9),
             "beam": dict(num_beams=3)}


@pytest.mark.gpu
def test_graphed_engine_answers_as_the_eager_one_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.train import graphs

    graphed, eager, seqs, stamps = _card_engines(tmp_path)
    assert graphed.graphed and not eager.graphed
    graphs.counts.clear()
    for _ in range(2):  # the second call of each program replays, no capture
        got, want = graphed.retrieve(seqs, stamps), eager.retrieve(seqs, stamps)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        for mode, kw in _GENERATE.items():
            got = graphed.generate(seqs, stamps, steps=4, mode=mode, **kw)
            assert got == eager.generate(seqs, stamps, steps=4, mode=mode, **kw), mode
    assert dict(graphs.counts["serve"]) == {
        "captures": 4, "warmup_runs": 4 * graphs.WARMUP_RUNS, "replays": 8}
    assert len(graphed._programs) == 4
    # another temperature, top-k and top-p: the same sample program
    graphed.generate(seqs, stamps, steps=4, mode="sample", seed=1, temperature=0.3, top_k=0)
    assert graphs.counts["serve"]["captures"] == 4


@pytest.mark.gpu
def test_refreshed_candidates_reach_the_graphs_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    graphed, eager, seqs, stamps = _card_engines(tmp_path)
    before = graphed.retrieve(seqs, stamps)
    candidates = graphed.candidates
    with torch.no_grad():  # new weights into the model both engines serve
        for p in graphed.model.parameters():
            p.mul_(1.5).add_(0.01)
    for engine in (graphed, eager):
        engine.refresh_candidates()
    assert graphed.candidates is candidates  # refreshed in place: the buffer the graphs bound
    got, want = graphed.retrieve(seqs, stamps), eager.retrieve(seqs, stamps)
    assert got[0] == want[0] and got[0] != before[0]
    np.testing.assert_array_equal(got[1], want[1])
    for mode, kw in _GENERATE.items():
        got = graphed.generate(seqs, stamps, steps=4, mode=mode, **kw)
        assert got == eager.generate(seqs, stamps, steps=4, mode=mode, **kw), mode


# ---------------------------------------------------------------- a 10M-item catalog
# the gather loss and the lazy update on the card against the CPU (the
# tolerances of chip_smoke.py's phase 14), the lazy step's untouched rows
# through a graph, and the int8 scan at X = 100,000


def _smoke_cfg(*extra):
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train

    return cli_train.parse_args(["experiment=synthetic-smoke", *extra])


@pytest.mark.gpu
def test_gather_loss_and_gradients_on_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.configs import resolve
    from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
    from mygenerativerecommenders_tpu_torch.models.model import build_model
    from mygenerativerecommenders_tpu_torch.train.task_retrieval import make_loss_fn

    cfg = _smoke_cfg("model.loss.dense_catalog_negatives=false")
    data = RecoData(cfg.data, seed=42)
    resolve(cfg, data.max_item_id)
    batch = next(iter(data.loader("train")))
    n = batch["ids"].shape[1] + cfg.model.gr_output_length
    offsets = torch.randint(0, len(data.all_item_ids), (batch["ids"].shape[0], n, 16),
                            generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device, seed=5)
        loss_fn = make_loss_fn(model, cfg, data.all_item_ids)
        assert loss_fn.variant == "gather"
        loss = loss_fn({k: torch.as_tensor(v).to(device) for k, v in batch.items()},
                       neg_offsets=offsets.to(device))
        loss.backward()
        out[device] = loss.item(), {k: p.grad.cpu() for k, p in model.named_parameters()}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, want in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][name].numpy(), want.numpy(), rtol=5e-4,
                                   atol=1e-6, err_msg=name)


@pytest.mark.gpu
def test_lazy_step_on_card_matches_the_cpu_and_leaves_untouched_rows(tmp_path):
    """mv, the count and the other parameters card against CPU; the table on
    each device against the AdamW step of its own moments in float64 (Adam's
    first step lr * g / (|g| + eps) turns the float32 difference of a
    gradient near eps into up to lr / 4 of it, so the table is not held card
    against CPU directly); untouched rows bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.train.lazy_embedding import TABLE_KEY

    out = {}
    for device in ("cuda", "cpu"):
        trainer = _card_trainer(tmp_path, "lazy", 1, f"trainer.device={device}")
        batch = trainer._put(next(iter(trainer.data.loader("train"))))
        before = trainer.model.state_dict()[TABLE_KEY].detach().cpu().clone()
        offsets = torch.randint(0, len(trainer.all_item_ids), (16,),
                                generator=torch.Generator().manual_seed(2), dtype=torch.int32)
        trainer.train_step(batch, trainer.lr1, neg_offsets=offsets.to(device))
        state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        state["mv"] = trainer.optimizer.mv.detach().cpu()
        state["count"] = trainer.optimizer.count.cpu()
        out[device] = state
    opt = trainer.cfg.optimizer1
    touched = torch.zeros(before.shape[0], dtype=torch.bool)
    touched[batch["ids"].long()] = True
    touched[batch["target_id"].long()] = True
    touched[torch.as_tensor(trainer.all_item_ids)[offsets.long()].long()] = True
    touched[0] = True
    d = before.shape[1]
    p0 = before[touched].double()
    for device in ("cuda", "cpu"):
        state = out[device]
        assert torch.equal(state[TABLE_KEY][~touched], before[~touched])
        assert not state["mv"][~touched].any()
        mv = state["mv"][touched].double()
        b1, b2 = opt.betas
        step = mv[:, :d] / (1 - b1) / (torch.sqrt(mv[:, d:] / (1 - b2)) + opt.eps)
        want = p0 - opt.lr * (step + opt.weight_decay * p0)
        np.testing.assert_allclose(state[TABLE_KEY][touched].double().numpy(), want.numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=device)
    for name, want in out["cpu"].items():
        if name != TABLE_KEY:
            np.testing.assert_allclose(out["cuda"][name].numpy(), want.numpy(), rtol=5e-4,
                                       atol=1e-6, err_msg=name)


@pytest.mark.gpu
def test_graphed_lazy_steps_leave_untouched_rows_bit_for_bit(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.train.lazy_embedding import TABLE_KEY

    trainer = _card_trainer(tmp_path, "lazy", 3)
    trainer.model.train()
    table = trainer.model.state_dict()[TABLE_KEY]
    before = table.detach().clone()
    batches = [trainer._put(b) for _, b in zip(range(3), trainer.data.loader("train"))]
    offsets = [torch.randint(0, len(trainer.all_item_ids), (16,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(i)).cuda() for i in range(3)]
    trainer.train_steps(batches, trainer.lr1, neg_offsets=offsets)
    assert int(trainer.optimizer.count) == 3  # the capture's warm-up steps were undone
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device="cuda")
    for b, o in zip(batches, offsets):
        touched[b["ids"].long()] = True
        touched[b["target_id"].long()] = True
        touched[torch.as_tensor(trainer.all_item_ids, device="cuda")[o.long()].long()] = True
    touched[0] = True
    assert torch.equal(table[~touched], before[~touched])
    assert not trainer.optimizer.mv[~touched].any()
    assert (table[touched][1:] != before[touched][1:]).any()


@pytest.mark.gpu
@pytest.mark.parametrize("filtered", [False, True])
def test_int8_scan_on_card_matches_the_cpu(filtered):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from mygenerativerecommenders_tpu_torch.ops.quantized_topk import (
        mips_top_k_int8,
        quantize_catalog,
    )

    rng = np.random.default_rng(0)
    x, d, b, k = 100_000, 64, 64, 200
    items = rng.normal(size=(x, d)).astype(np.float32)
    items /= np.linalg.norm(items, axis=-1, keepdims=True)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    ids = np.arange(1, x + 1)
    invalid = rng.integers(1, x + 1, size=(b, 200)) if filtered else None
    out = {}
    for device in ("cuda", "cpu"):
        cat = quantize_catalog(torch.from_numpy(items).to(device))
        got = mips_top_k_int8(
            torch.from_numpy(queries).to(device), cat, torch.from_numpy(ids).to(device), k,
            invalid_ids=None if invalid is None else torch.from_numpy(invalid).to(device),
            max_item_id=x,
        )
        out[device] = cat.q.cpu(), cat.scales.cpu(), got[0].cpu(), got[1].cpu()
    (q1, s1, i1, v1), (q2, s2, i2, v2) = out["cuda"], out["cpu"]
    assert torch.equal(q1, q2) and torch.equal(s1, s2)  # the same int8 rows and scales
    from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree

    problem = topk_agree(i1.numpy(), v1.numpy(), i2.numpy(), v2.numpy(), 1e-5)
    assert problem is None, problem


@pytest.mark.gpu
def test_real_files_prepare_train_and_predict_on_card(tmp_path):
    """A small ml-1m-format zip: cli.prepare_data, two epochs of cli.train on
    the card (graphed, the kernels launched), then cli.predict from the best
    checkpoint, whose rows hold catalog ids and agree with a CPU trainer's
    predict on the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    import csv

    from mygenerativerecommenders_tpu_torch.cli import predict, prepare_data
    from mygenerativerecommenders_tpu_torch.cli import train as cli_train
    from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
    from mygenerativerecommenders_tpu_torch.train.driver import Trainer
    # by the directory pytest puts first on sys.path: a package named "tests"
    # installed on the card's machine would shadow this one
    from torch_port_real_files import write_ml1m_zip

    write_ml1m_zip(tmp_path, num_users=40)
    args = [
        "experiment=ml-1m-hstu", f"data.data_dir={tmp_path}",
        f"trainer.output_dir={tmp_path / 'out'}", "trainer.max_epochs=2", "trainer.min_epochs=1",
        "data.max_sequence_length=32", "data.batch_size=16", "model.index.k=20",
        "model.metrics.at_k_list=[5,10,20]", "trainer.monitor=val/ndcg@10",
    ]
    data = prepare_data.main(args)
    before = (kern.launches, kern.bwd_launches, count_kern.launches, lse_kern.launches,
              lse_kern.bwd_launches)
    cli_train.main(args)
    after = (kern.launches, kern.bwd_launches, count_kern.launches, lse_kern.launches,
             lse_kern.bwd_launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)
    best = tmp_path / "out" / "ml-1m-hstu" / "checkpoints" / "best.pt"
    out = predict.main(args + [f"trainer.ckpt_path={best}"])
    with open(out, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 40
    catalog = set(data.all_item_ids.tolist())
    ids = [eval(r["top_k_ids"]) for r in rows]
    scores = [eval(r["top_k_scores"]) for r in rows]
    assert all(len(row) == 20 and set(row) <= catalog for row in ids)
    cpu = Trainer(cli_train.parse_args(args + ["trainer.device=cpu"]))
    cpu.load_weights(best)
    want = cpu.predict()
    problem = topk_agree(ids, scores, want["top_k_ids"], want["top_k_scores"], atol=1e-4)
    assert problem is None, problem
