"""Dense-catalog negative log-sum-exp: the Hopper kernels' wrapper and its
plain version.

`dense_neg_lse(q [BT, D], cat [X, D], count [BT, X], temperature)` returns
`lse [BT]` with

    lse[i] = log sum_x count[i, x] * exp(q[i] . cat[x] / temperature)

over the logits whose count is positive, and -inf for a row with none. count
is uint8, or int32 where R > 255 draws a row could pass a byte
(ops/kernels/count_offsets.py). It is
`fused_dense_neg_lse_t` of the JAX package (ops/pallas/dense_softmax.py:633)
on a plain [BT, X] count, with that function's edge semantics (:421, :445-448,
:178-182; the jnp form is ops/dense_negatives.py:229-255): the select comes
before the exponential, `m_safe` is 0 for a row with no live logit, and the
gradient reaching such a row is dropped.

On CUDA tensors it is a `torch.autograd.Function`: the forward launches
`dense_neg_lse_fwd` of csrc/dense_neg_lse.cu and keeps q, cat, count and the
per-row (m_safe, s); the backward launches `dense_neg_lse_bwd`. Both walk
each row's live logits only (count > 0), so the [BT, X] logits are neither
computed whole nor stored. Both are built by nvcc at first use; a failed
build or launch raises. On CPU tensors it computes `dense_neg_lse_plain` and
autograd differentiates that. No gradient flows to count.
`dense_neg_lse_stats` gives the forward's lse and per-row (m_safe, s)
without a gradient. In the kernels' sparse form, in plain PyTorch:
`dense_neg_lse_stats_sparse_plain` is the forward's (m_safe, s) and
`dense_neg_lse_bwd_plain` the backward given them
(`dense_neg_lse_stats_plain` is the dense form of the former).

`fused_dense_neg_lse(q2, norm_catalog, count, sup_off, temperature)` is the
JAX package's function of that name (dense_softmax.py:167-175, the kernels
`_fwd_kernel` :75 and `_bwd_single_kernel` / `_bwd_dq_kernel` /
`_bwd_dcat_kernel` :116-152): the same lse, with each row's positive masked
inside the kernels (count zeroed at x == sup_off[i], -1 for none) and a count
whose rows may be padded to the catalog rounded up to 128. It launches the
same two entry points with a `sup_off` pointer, which the training path
leaves null; its plain version is `fused_dense_neg_lse_plain`, and it counts
its launches apart (`fused_launches`, `fused_bwd_launches`). Nothing in the
JAX package calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mygenerativerecommenders_tpu_torch.ops.kernels import _build

LIBRARY = "dense_neg_lse"  # one source holds both kernels
KERNEL = "dense_neg_lse_fwd"
KERNEL_BWD = "dense_neg_lse_bwd"
SOURCE = "mygenerativerecommenders_tpu_torch/csrc/dense_neg_lse.cu"
REPLACES = "mygenerativerecommenders_tpu/ops/pallas/dense_softmax.py:425"
REPLACES_BWD = "mygenerativerecommenders_tpu/ops/pallas/dense_softmax.py:464"
# the same backward entry point on a catalog wider than one x-block of the TPU
# kernels (X > 4096: `_bwd_dq_kernel3` :491 and `_bwd_dcat_kernel3` :509). The
# TPU splits dq and dcat there because a Pallas output block must be revisited
# on consecutive grid steps; the CUDA kernel walks any X in one launch and adds
# its dcat partials with atomics
REPLACES_WIDE = "mygenerativerecommenders_tpu/ops/pallas/dense_softmax.py:491"
FUSED = "fused_dense_neg_lse"
REPLACES_FUSED = "mygenerativerecommenders_tpu/ops/pallas/dense_softmax.py:75"
REPLACES_FUSED_BWD = "mygenerativerecommenders_tpu/ops/pallas/dense_softmax.py:116"
# kernel launches so far, forward and backward, of `dense_neg_lse` and of
# `fused_dense_neg_lse`; callers that count (chip_smoke.py) reset them to 0
launches = 0
bwd_launches = 0
fused_launches = 0
fused_bwd_launches = 0

_NO_LOGIT = -1e30
_lib: Optional[ctypes.CDLL] = None


def dense_neg_lse_stats_plain(
    q: torch.Tensor, cat: torch.Tensor, count: torch.Tensor, temperature: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's per-row (m_safe, s) in plain PyTorch, [BT] each."""
    al = (q.float() @ cat.float().T) / temperature
    c = count.to(torch.float32)
    # select before exponentiating: a dead logit above the live maximum
    # would overflow exp and poison the sum with 0 * inf
    al_live = torch.where(c > 0, al, _NO_LOGIT)
    m = al_live.max(dim=-1).values
    m_safe = torch.where(m > 0.5 * _NO_LOGIT, m, 0.0)
    return m_safe, (c * torch.exp(al_live - m_safe[:, None])).sum(dim=-1)


def _lse(m_safe: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, m_safe + torch.log(torch.clamp(s, min=1e-30)), -torch.inf)


def dense_neg_lse_plain(
    q: torch.Tensor, cat: torch.Tensor, count: torch.Tensor, temperature: float
) -> torch.Tensor:
    """The kernels' function in plain PyTorch, [BT] float32."""
    return _lse(*dense_neg_lse_stats_plain(q, cat, count, temperature))


def _live_pairs(
    count: torch.Tensor, x: int, sup_off: Optional[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (row, column) of each live logit: count > 0 in the catalog's x
    columns (count may be wider), and column != sup_off[row]."""
    rows, cols = (count[:, :x] > 0).nonzero(as_tuple=True)
    if sup_off is not None:
        keep = cols != sup_off.to(cols.device).long()[rows]
        rows, cols = rows[keep], cols[keep]
    return rows, cols


def dense_neg_lse_stats_sparse_plain(
    q: torch.Tensor,
    cat: torch.Tensor,
    count: torch.Tensor,
    temperature: float,
    sup_off: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's per-row (m_safe, s) in plain PyTorch, in its
    sparse form: the live (i, x) pairs (count > 0, x != sup_off[i]) only, the
    row maximum of al by `scatter_reduce` and s by `index_add_`. count may be
    wider than the catalog, as `fused_dense_neg_lse` takes it."""
    q, cat = q.float(), cat.float()
    rows, cols = _live_pairs(count, cat.shape[0], sup_off)
    al = (q[rows] * cat[cols]).sum(dim=-1) * (1.0 / temperature)
    m = torch.full((q.shape[0],), _NO_LOGIT, dtype=torch.float32, device=q.device)
    m = m.scatter_reduce(0, rows, al, "amax")
    m_safe = torch.where(m > 0.5 * _NO_LOGIT, m, 0.0)
    terms = count[rows, cols].float() * torch.exp(al - m_safe[rows])
    return m_safe, torch.zeros_like(m_safe).index_add_(0, rows, terms)


def dense_neg_lse_bwd_plain(
    q: torch.Tensor,
    cat: torch.Tensor,
    count: torch.Tensor,
    m_safe: torch.Tensor,
    s: torch.Tensor,
    gl: torch.Tensor,
    temperature: float,
    sup_off: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's (dq, dcat) in plain PyTorch, in its sparse form:
    the live (i, x) pairs (count > 0, x != sup_off[i]), cat gathered at them,
    dal = count exp(al - m_safe) gl / max(s, 1e-30) / tau (0 where s == 0),
    dq = dal cat and dcat = dal^T q by `index_add_`. count may be wider than
    the catalog where sup_off is given, as `fused_dense_neg_lse` takes it."""
    q, cat = q.float(), cat.float()
    rows, cols = _live_pairs(count, cat.shape[0], sup_off)
    inv_tau = 1.0 / temperature
    coef = torch.where(s > 0, gl.float() / torch.clamp(s, min=1e-30) * inv_tau, 0.0)
    qr, cc = q[rows], cat[cols]
    al = (qr * cc).sum(dim=-1) * inv_tau
    dal = count[rows, cols].float() * torch.exp(al - m_safe[rows]) * coef[rows]
    dq = torch.zeros_like(q).index_add_(0, rows, dal[:, None] * cc)
    dcat = torch.zeros_like(cat).index_add_(0, cols, dal[:, None] * qr)
    return dq, dcat


def fused_dense_neg_lse_plain(
    q2: torch.Tensor,
    norm_catalog: torch.Tensor,
    count: torch.Tensor,
    sup_off: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """`fused_dense_neg_lse` in plain PyTorch, [BT] float32."""
    x = norm_catalog.shape[0]
    hit = torch.arange(x, device=count.device)[None, :] == sup_off.to(count.device)[:, None]
    masked = torch.where(hit, 0, count[:, :x]).to(torch.uint8)
    return dense_neg_lse_plain(q2, norm_catalog, masked, temperature)


def _check(q, cat, count, sup_off=None):
    if q.ndim != 2 or cat.ndim != 2 or q.shape[1] != cat.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and cat {tuple(cat.shape)} must be [BT, D], [X, D]")
    bt, x = q.shape[0], cat.shape[0]
    # without sup_off the count is [BT, X]; with it, rows may be padded to
    # X rounded up to 128, as the JAX counts are born (dense_softmax.py:194)
    widths = (x,) if sup_off is None else (x, -(-x // 128) * 128)
    if count.ndim != 2 or count.shape[0] != bt or count.shape[1] not in widths:
        raise ValueError(f"count must be [{bt}, {' or '.join(map(str, widths))}], got "
                         f"{tuple(count.shape)}")
    # sup_off: the JAX kernels' uint8 counts (R <= 255) only
    types = (torch.uint8,) if sup_off is not None else (torch.uint8, torch.int32)
    if count.dtype not in types:
        raise ValueError(f"count must be {' or '.join(str(t)[6:] for t in types)}, got "
                         f"{count.dtype}")
    operands = [q, cat, count]
    if sup_off is not None:
        if tuple(sup_off.shape) != (bt,):
            raise ValueError(f"sup_off must be [{bt}], got {tuple(sup_off.shape)}")
        operands.append(sup_off)
    if len({t.device for t in operands}) != 1:
        raise ValueError("q, cat, count and sup_off must be on one device")


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(LIBRARY)
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.dense_neg_lse_fwd.argtypes = [p] * 7 + [i, i, i, ll, f, i, p]
        lib.dense_neg_lse_fwd.restype = i
        lib.dense_neg_lse_bwd.argtypes = [p] * 10 + [i, i, i, ll, f, i, p]
        lib.dense_neg_lse_bwd.restype = i
        lib.dense_neg_lse_max_depth.argtypes = []
        lib.dense_neg_lse_max_depth.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer, or the kernels' null pointer for None."""
    return None if t is None else t.data_ptr()


def _wide(count: torch.Tensor) -> int:
    """The kernels' `wide` flag: 1 for an int32 count, 0 for uint8."""
    return int(count.dtype == torch.int32)


def _raise_on(lib, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def _forward(q, cat, count, sup_off, inv_tau):
    """Launches the forward kernel: (lse, m_safe, s) and the operands as the
    kernels take them (`sup_off` None: the null pointer)."""
    global launches, fused_launches
    lib = _kernel_lib()
    bt, d = q.shape
    x = cat.shape[0]
    if d > lib.dense_neg_lse_max_depth():
        raise ValueError(f"D={d} is wider than the kernels take")
    if q.dtype != torch.float32 or cat.dtype != torch.float32:
        raise TypeError(f"q and cat must be float32, got {q.dtype} and {cat.dtype}")
    q, cat = q.detach().contiguous(), cat.detach().contiguous()
    count = count.contiguous()
    sup = None if sup_off is None else sup_off.to(torch.int32).contiguous()
    lse, m_safe, s = (torch.empty((bt,), dtype=torch.float32, device=q.device) for _ in range(3))
    if bt > 0:
        err = lib.dense_neg_lse_fwd(
            q.data_ptr(), cat.data_ptr(), count.data_ptr(), _ptr(sup),
            lse.data_ptr(), m_safe.data_ptr(), s.data_ptr(),
            bt, d, x, count.stride(0), inv_tau, _wide(count),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _raise_on(lib, err, KERNEL)
        if sup is None:
            launches += 1
        else:
            fused_launches += 1
    return (lse, m_safe, s), (q, cat, count, sup)


class _DenseNegLse(torch.autograd.Function):
    """`sup_off` None is the training path's `dense_neg_lse` (the kernels'
    null pointer); a tensor is `fused_dense_neg_lse`."""

    @staticmethod
    def forward(ctx, q, cat, count, sup_off, inv_tau):
        (lse, m_safe, s), operands = _forward(q, cat, count, sup_off, inv_tau)
        ctx.save_for_backward(*operands, m_safe, s)
        ctx.inv_tau = inv_tau
        return lse

    @staticmethod
    def backward(ctx, gl):
        global bwd_launches, fused_bwd_launches
        q, cat, count, sup, m_safe, s = ctx.saved_tensors
        lib = _kernel_lib()
        bt, d = q.shape
        x = cat.shape[0]
        gl = gl.to(torch.float32).contiguous()
        dq = torch.empty_like(q)
        if bt == 0:
            return dq, torch.zeros_like(cat), None, None, None
        # the walk adds into a float64 dcat with atomics; the same call
        # rounds it into dcat
        acc = torch.zeros(cat.shape, dtype=torch.float64, device=cat.device)
        dcat = torch.empty_like(cat)
        err = lib.dense_neg_lse_bwd(
            q.data_ptr(), cat.data_ptr(), count.data_ptr(), _ptr(sup),
            m_safe.data_ptr(), s.data_ptr(), gl.data_ptr(), dq.data_ptr(),
            acc.data_ptr(), dcat.data_ptr(), bt, d, x, count.stride(0), ctx.inv_tau,
            _wide(count), torch.cuda.current_stream(q.device).cuda_stream,
        )
        _raise_on(lib, err, KERNEL_BWD)
        if sup is None:
            bwd_launches += 1
        else:
            fused_bwd_launches += 1
        return dq, dcat, None, None, None


def dense_neg_lse(
    q: torch.Tensor, cat: torch.Tensor, count: torch.Tensor, temperature: float
) -> torch.Tensor:
    """q [BT, D], cat [X, D], count [BT, X] uint8 or int32 -> lse [BT]
    float32, differentiable in q and cat."""
    _check(q, cat, count)
    if q.device.type == "cpu":
        return dense_neg_lse_plain(q, cat, count, temperature)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _DenseNegLse.apply(q, cat, count, None, float(1.0 / temperature))


def fused_dense_neg_lse(
    q2: torch.Tensor,
    norm_catalog: torch.Tensor,
    count: torch.Tensor,
    sup_off: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """neg_lse [BT] for flattened queries q2 [BT, D] vs catalog [X, D].

    count: [BT, X or X rounded up to 128] uint8 multiplicities, the dtype of
    the JAX package's counts when R <= 255 (ops/dense_negatives.py:88-92); any
    other dtype raises. sup_off: [BT] int catalog offset of each row's
    positive (-1 = none), whose count is taken as 0. Differentiable in q2 and
    norm_catalog.
    """
    _check(q2, norm_catalog, count, sup_off)
    if q2.device.type == "cpu":
        return fused_dense_neg_lse_plain(q2, norm_catalog, count, sup_off, temperature)
    if q2.device.type != "cuda":
        raise ValueError(f"no kernel for device {q2.device}")
    return _DenseNegLse.apply(q2, norm_catalog, count, sup_off, float(1.0 / temperature))


def dense_neg_lse_stats(
    q: torch.Tensor,
    cat: torch.Tensor,
    count: torch.Tensor,
    temperature: float,
    sup_off: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's (lse, m_safe, s), [BT] each, without a gradient: the
    kernel on CUDA tensors (counted as `dense_neg_lse`'s launch, or with
    sup_off as `fused_dense_neg_lse`'s), `dense_neg_lse_stats_sparse_plain`
    on CPU tensors. Operands as `dense_neg_lse` takes them, or with sup_off
    as `fused_dense_neg_lse` does."""
    _check(q, cat, count, sup_off)
    if q.device.type == "cpu":
        m_safe, s = dense_neg_lse_stats_sparse_plain(q, cat, count, temperature, sup_off)
        return _lse(m_safe, s), m_safe, s
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _forward(q, cat, count, sup_off, float(1.0 / temperature))[0]
