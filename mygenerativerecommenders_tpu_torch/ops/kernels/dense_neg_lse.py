"""Dense-catalog negative log-sum-exp: the Hopper kernels' wrapper and its
plain version.

`dense_neg_lse(q [BT, D], cat [X, D], count [BT, X] uint8, temperature)`
returns `lse [BT]` with

    lse[i] = log sum_x count[i, x] * exp(q[i] . cat[x] / temperature)

over the logits whose count is positive, and -inf for a row with none. It is
`fused_dense_neg_lse_t` of the JAX package (ops/pallas/dense_softmax.py:633)
on a plain [BT, X] count, with that function's edge semantics (:421, :445-448,
:178-182; the jnp form is ops/dense_negatives.py:229-255): the select comes
before the exponential, `m_safe` is 0 for a row with no live logit, and the
gradient reaching such a row is dropped.

On CUDA tensors it is a `torch.autograd.Function`: the forward launches
`dense_neg_lse_fwd` of csrc/dense_neg_lse.cu and keeps q, cat, count and the
per-row (m_safe, s); the backward launches `dense_neg_lse_bwd`, which
recomputes the logits and returns dq and dcat. The [BT, X] logits never reach
device memory. Both are built by nvcc at first use; a failed build or launch
raises. On CPU tensors it computes `dense_neg_lse_plain` and autograd
differentiates that. No gradient flows to count.
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
# kernel launches so far, forward and backward; callers that count
# (chip_smoke.py) reset them to 0
launches = 0
bwd_launches = 0

_NO_LOGIT = -1e30
_lib: Optional[ctypes.CDLL] = None


def dense_neg_lse_plain(
    q: torch.Tensor, cat: torch.Tensor, count: torch.Tensor, temperature: float
) -> torch.Tensor:
    """The kernels' function in plain PyTorch, [BT] float32."""
    al = (q.float() @ cat.float().T) / temperature
    c = count.to(torch.float32)
    # select before exponentiating: a dead logit above the live maximum
    # would overflow exp and poison the sum with 0 * inf
    al_live = torch.where(c > 0, al, _NO_LOGIT)
    m = al_live.max(dim=-1).values
    m_safe = torch.where(m > 0.5 * _NO_LOGIT, m, 0.0)
    s = (c * torch.exp(al_live - m_safe[:, None])).sum(dim=-1)
    return torch.where(s > 0, m_safe + torch.log(torch.clamp(s, min=1e-30)), -torch.inf)


def _check(q, cat, count):
    if q.ndim != 2 or cat.ndim != 2 or q.shape[1] != cat.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and cat {tuple(cat.shape)} must be [BT, D], [X, D]")
    if tuple(count.shape) != (q.shape[0], cat.shape[0]) or count.dtype != torch.uint8:
        raise ValueError(
            f"count must be uint8 [{q.shape[0]}, {cat.shape[0]}], got "
            f"{count.dtype} {tuple(count.shape)}"
        )
    if len({q.device, cat.device, count.device}) != 1:
        raise ValueError("q, cat and count must be on one device")


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(LIBRARY)
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.dense_neg_lse_fwd.argtypes = [p] * 6 + [i, i, i, f, p]
        lib.dense_neg_lse_fwd.restype = i
        lib.dense_neg_lse_bwd.argtypes = [p] * 8 + [i, i, i, f, p]
        lib.dense_neg_lse_bwd.restype = i
        lib.dense_neg_lse_fwd_smem_bytes.argtypes = [i]
        lib.dense_neg_lse_fwd_smem_bytes.restype = ll
        lib.dense_neg_lse_bwd_smem_bytes.argtypes = [i]
        lib.dense_neg_lse_bwd_smem_bytes.restype = ll
        lib.dense_neg_lse_max_depth.argtypes = []
        lib.dense_neg_lse_max_depth.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


class _DenseNegLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, cat, count, inv_tau):
        global launches
        lib = _kernel_lib()
        bt, d = q.shape
        x = cat.shape[0]
        if d > lib.dense_neg_lse_max_depth():
            raise ValueError(f"D={d} is wider than the kernels take")
        for smem in (lib.dense_neg_lse_fwd_smem_bytes(d), lib.dense_neg_lse_bwd_smem_bytes(d)):
            if smem > _build.MAX_SMEM_BYTES:
                raise ValueError(f"D={d}: a block would need {smem} bytes of shared memory")
        if q.dtype != torch.float32 or cat.dtype != torch.float32:
            raise TypeError(f"q and cat must be float32, got {q.dtype} and {cat.dtype}")
        q, cat = q.detach().contiguous(), cat.detach().contiguous()
        count = count.contiguous()
        lse, m_safe, s = (
            torch.empty((bt,), dtype=torch.float32, device=q.device) for _ in range(3)
        )
        if bt > 0:
            err = lib.dense_neg_lse_fwd(
                q.data_ptr(), cat.data_ptr(), count.data_ptr(),
                lse.data_ptr(), m_safe.data_ptr(), s.data_ptr(),
                bt, d, x, inv_tau, torch.cuda.current_stream(q.device).cuda_stream,
            )
            _raise_on(lib, err, KERNEL)
            launches += 1
        ctx.save_for_backward(q, cat, count, m_safe, s)
        ctx.inv_tau = inv_tau
        return lse

    @staticmethod
    def backward(ctx, gl):
        global bwd_launches
        q, cat, count, m_safe, s = ctx.saved_tensors
        lib = _kernel_lib()
        bt, d = q.shape
        x = cat.shape[0]
        gl = gl.to(torch.float32).contiguous()
        dq = torch.empty_like(q)
        dcat = torch.zeros_like(cat)  # the kernel adds into it with atomics
        if bt > 0:
            err = lib.dense_neg_lse_bwd(
                q.data_ptr(), cat.data_ptr(), count.data_ptr(), m_safe.data_ptr(),
                s.data_ptr(), gl.data_ptr(), dq.data_ptr(), dcat.data_ptr(),
                bt, d, x, ctx.inv_tau, torch.cuda.current_stream(q.device).cuda_stream,
            )
            _raise_on(lib, err, KERNEL_BWD)
            bwd_launches += 1
        return dq, dcat, None, None


def dense_neg_lse(
    q: torch.Tensor, cat: torch.Tensor, count: torch.Tensor, temperature: float
) -> torch.Tensor:
    """q [BT, D], cat [X, D], count [BT, X] uint8 -> lse [BT] float32,
    differentiable in q and cat."""
    _check(q, cat, count)
    if q.device.type == "cpu":
        return dense_neg_lse_plain(q, cat, count, temperature)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _DenseNegLse.apply(q, cat, count, float(1.0 / temperature))
