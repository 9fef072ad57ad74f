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
    "bt,r,x", [(100, 16, 200), (2000, 128, 3706), (64, 255, 26744), (64, 256, 26744),
               (300, 300, 3706)]
)
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
    assert got.dtype == (torch.uint8 if r <= 255 else torch.int32)
    assert torch.equal(got, count_kern.count_offsets_plain(o, p, x))


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
                 (1000, 50, 3706, 256), (130, 64, 700, 300), (1000, 64, 150, 255)]
)
def test_dense_neg_lse_kernels_match_plain_on_card(bt, d, x, r):
    """r > 255 draws a row: int32 counts, some of them above 255. 255 draws
    into 150 columns: rows with more live logits than the backward lists at
    once. dq takes no atomics: the same bits in a second call."""
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
    """The lse kernels with sup_off against the plain version; an all -1
    sup_off gives the bits of the training path's null pointer."""
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
    _check_lse_backward(q, cat, count, lse, gl, got, sup, no_hits)
    # all -1 masks nothing: the null pointer's lse and dq to the bit
    none = torch.full_like(sup, -1)
    masked, masked_grads = run(lse_kern.fused_dense_neg_lse, none)
    null = lse_kern.dense_neg_lse(q, cat, count[:, :x].contiguous(), 0.05)
    null_dq = torch.autograd.grad(
        (torch.where(torch.isfinite(null), null, 0.0) * gl).sum(), [q])[0]
    assert torch.equal(masked, null) and torch.equal(masked_grads[0], null_dq)
