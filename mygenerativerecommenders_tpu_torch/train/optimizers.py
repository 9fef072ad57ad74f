"""Optimizers and the two-optimizer split. Port of
mygenerativerecommenders_tpu/train/optimizers.py: `zeropower_via_newtonschulz5`
(:39-52), `muon` (:55-105), `_scion_lmo` and `scion` (:112-186),
`build_single` (:189-214), `param_labels` (:217-244), `scion_init_params`
(:247-271) and `build_optimizer` (:280-294).

- AdamW and SGD are torch's: `torch.optim.AdamW` computes what `optax.adamw`
  computes (bias-corrected moments, eps outside the root, decoupled weight
  decay lr * wd * p on every parameter), `torch.optim.SGD` with momentum
  `optax.sgd(momentum=...)`'s trace.
- `Muon` and `Scion` are this module's, line for line the JAX transforms:
  momentum by lerp (Muon) or EMA (Scion), Newton-Schulz-5 in bfloat16 on the
  updates of parameters with two or more dimensions, Muon's shape scale
  max(1, rows/cols)^0.5 and decoupled weight decay, Scion's six norm LMOs.
  Everything whose result depends on the matrix's orientation (NS-5 itself,
  the scales, the col / row norms, the orthogonal init) is computed on the
  JAX layout: a parameter the port stores transposed (`_o.weight`, torch
  Linear's [out, in] against flax's [in, out] kernel;
  `checkpoint.transposed_from_jax`) is handed over as its transpose and the
  result written back transposed. A parameter of more than two dimensions
  (SASRec's attention kernels, [D, H, d] and [H, d, D] in flax's layout,
  models/dense.py) is flattened to [shape[0], prod(shape[1:])] for NS-5,
  the scales and the orthogonal init, as JAX flattens it, and reshaped
  back. `torch.optim.Muon` would scale by the
  torch layout, takes 2-D parameters only and normalises with
  clamp(min=eps) instead of + 1e-7. A parameter placed over a process group
  (a TP block or a table's shard, parallel/tensor_parallel.py) is
  orthogonalised whole, as GSPMD gives JAX: the update's blocks are
  all-gathered, NS-5 (or Scion's LMO) runs on the whole matrix, and the
  rank keeps its block. Everything else in both is elementwise.
- With `optimizer2.enabled`, `build_optimizer` returns a `SplitOptimizer`:
  optimizer1 over the parameters `param_labels` calls "primary" (the
  embeddings and every parameter of fewer than two dimensions), optimizer2
  over the "matrix" ones (the encoder's matrices), each at its own rate, as
  JAX's `optax.multi_transform` over the same labels.

The learning rates are set per step by the plateau controllers (`set_lr`:
lr1 to optimizer1, lr2 to optimizer2). Muon and Scion keep theirs in a
1-element float32 tensor on the parameters' device, and neither syncs with
the host: a CUDA graph of the step (train/graphs.py) captures their update
and reads the rate in place. With `fused=True` (the trainer's choice on cuda)
AdamW and SGD run their fused kernels with such a tensor rate too; AdamW is
then also `capturable`, which only lets `torch.cuda.graph` take its `step()`
(the fused update's arithmetic is the same). Without it (the CPU) AdamW and
SGD are the plain ones with a float learning rate.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from mygenerativerecommenders_tpu_torch.checkpoint import jax_tree_to_state_dict, transposed_from_jax
from mygenerativerecommenders_tpu_torch.configs import OptimizerConfig

Named = List[Tuple[str, torch.nn.Parameter]]
Params = Iterable[Union[torch.nn.Parameter, Tuple[str, torch.nn.Parameter]]]

# --------------------------------------------------------------------------
# Newton-Schulz-5 (bfloat16), JAX :39-52
# --------------------------------------------------------------------------


def zeropower_via_newtonschulz5(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """The quintic Newton-Schulz iteration towards the orthogonal factor of
    `g`, in bfloat16, op for op JAX's: the Frobenius norm of the bfloat16
    matrix as `jnp.linalg.norm` takes it (the root of the sum of the
    bfloat16 squares; `torch.linalg.norm` rounds once, after a float32 sum
    of the squares, and so differs from it in the last bit of one matrix in
    seven) plus 1e-7, and the wide orientation (a tall matrix is transposed
    in and out). No host sync."""
    a, b, c = 3.4445, -4.7750, 2.0315
    transpose = g.shape[-2] > g.shape[-1]
    x = g.to(torch.bfloat16)
    if transpose:
        x = x.transpose(-1, -2)
    x = x / (torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True)) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.transpose(-1, -2)
        bmat = b * xxt + c * (xxt @ xxt)
        x = a * x + bmat @ x
    if transpose:
        x = x.transpose(-1, -2)
    return x


def _in_jax_layout(t: torch.Tensor, transposed: bool, fn) -> torch.Tensor:
    """fn on `t` as JAX lays the parameter out, the result in the port's layout."""
    return fn(t.t()).t() if transposed else fn(t)


def _on_whole(p: torch.Tensor, t: torch.Tensor, fn) -> torch.Tensor:
    """fn on the whole matrix of `t`, a tensor of p's shape: where p is a
    placed block (parallel/tensor_parallel.py), the blocks of t gathered
    over the mesh, fn, and this rank's block of the result."""
    placement = getattr(p, "placement", None)
    if placement is None:
        return fn(t)
    from mygenerativerecommenders_tpu_torch.parallel import tensor_parallel as tp

    groups = tp.mesh_groups()
    return tp.local_block(fn(tp.full_tensor(t, placement, groups)), placement, groups)


def _muon_orthogonalize(upd: torch.Tensor, ns_steps: int) -> torch.Tensor:
    """NS-5 of the [rows, rest] flattening times max(1, rows/cols)^0.5,
    multiplied in bfloat16 as JAX's `orth * scale` is."""
    flat = upd.reshape(upd.shape[0], -1) if upd.ndim > 2 else upd
    orth = zeropower_via_newtonschulz5(flat, ns_steps)
    scale = max(1.0, flat.shape[-2] / flat.shape[-1]) ** 0.5
    return (orth * scale).reshape(upd.shape)


def scion_lmo(g: torch.Tensor, norm: str, ns_steps: int) -> torch.Tensor:
    """JAX's `_scion_lmo` on `g` in the JAX layout."""
    eps = 1e-8
    if norm == "auto":
        return scion_lmo(g, "spectral" if g.ndim >= 2 else "bias_rms", ns_steps)
    if norm == "spectral":
        flat = g.reshape(g.shape[0], -1) if g.ndim > 2 else g
        orth = zeropower_via_newtonschulz5(flat, ns_steps).to(g.dtype)
        d_out, d_in = flat.shape
        return (orth * (d_out / d_in) ** 0.5).reshape(g.shape)
    if norm == "bias_rms":
        rms = torch.sqrt(torch.mean(g**2, dim=0, keepdim=True))
        return g / (rms + eps)
    if norm == "col":
        rms = torch.sqrt(torch.sum(g**2, dim=0, keepdim=True)) / (g.shape[0] ** 0.5)
        return g / (rms + eps)
    if norm == "row":
        rms = torch.sqrt(torch.sum(g**2, dim=-1, keepdim=True)) * (g.shape[-1] ** 0.5)
        return g / (rms + eps)
    if norm == "sign":
        return torch.sign(g) / g.shape[-1]
    raise ValueError(f"Unknown scion norm {norm}")


# --------------------------------------------------------------------------
# Muon and Scion, JAX :55-186
# --------------------------------------------------------------------------


class Muon(torch.optim.Optimizer):
    """JAX's `muon` chained with `add_decayed_weights` and the learning rate:
    buf <- lerp(buf, g, 1 - momentum); u = g + momentum (buf - g) (Nesterov)
    or buf; u <- NS-5(u) max(1, rows/cols)^0.5 for parameters of two or more
    dimensions (the others pass through as SGD-momentum); p <- p + (u + wd p)
    (-lr). A group's `transposed` marks parameters stored as the transpose
    of their JAX layout."""

    def __init__(self, params, lr: torch.Tensor, momentum: float = 0.95, nesterov: bool = True,
                 ns_steps: int = 5, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      ns_steps=ns_steps, weight_decay=weight_decay,
                                      transposed=False))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            m, lr, wd = group["momentum"], group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.copy_(buf + (1.0 - m) * (g - buf))
                upd = g + m * (buf - g) if group["nesterov"] else buf
                if upd.ndim >= 2:
                    upd = _on_whole(p, upd, lambda whole: _in_jax_layout(
                        whole, group["transposed"],
                        lambda u: _muon_orthogonalize(u, group["ns_steps"]),
                    )).to(g.dtype)
                if wd:
                    upd = upd + wd * p
                p.add_(upd * -lr)


class Scion(torch.optim.Optimizer):
    """JAX's `scion`: buf <- (1 - momentum) buf + momentum g (the buffer is
    left as it is at momentum 1, and the gradient taken instead);
    p <- p - lr scale lmo(buf) [- lr p when constrained]."""

    def __init__(self, params, lr: torch.Tensor, momentum: float = 0.1, norm: str = "auto",
                 scale: float = 1.0, unconstrained: bool = True, ns_steps: int = 5):
        super().__init__(params, dict(lr=lr, momentum=momentum, norm=norm, scale=scale,
                                      unconstrained=unconstrained, ns_steps=ns_steps,
                                      transposed=False))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            m, lr = group["momentum"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = g
                if m != 1.0:
                    buf = state["momentum_buffer"]
                    buf.copy_((1.0 - m) * buf + m * g)
                lmo = _on_whole(p, buf, lambda whole: _in_jax_layout(
                    whole, group["transposed"] and whole.ndim == 2,
                    lambda b: scion_lmo(b, group["norm"], group["ns_steps"]),
                ))
                upd = -lr * group["scale"] * lmo
                if not group["unconstrained"]:
                    upd = upd - lr * p
                p.add_(upd.to(p.dtype))


class SplitOptimizer:
    """JAX's `optax.multi_transform` over `param_labels`: `primary`
    (optimizer1) steps the "primary" parameters, `matrix` (optimizer2) the
    "matrix" ones, each at its own learning rate (`rate_groups`).
    `param_groups` and `state` are both parts' (the snapshot of
    train/graphs.py reads them); `state_dict()` holds each part's."""

    def __init__(self, primary: torch.optim.Optimizer, matrix: torch.optim.Optimizer):
        self.primary = primary
        self.matrix = matrix

    @property
    def param_groups(self) -> list:
        return self.primary.param_groups + self.matrix.param_groups

    @property
    def state(self) -> Dict[torch.Tensor, Dict[str, Any]]:
        return {**self.primary.state, **self.matrix.state}

    def rate_groups(self) -> Tuple[list, list]:
        return self.primary.param_groups, self.matrix.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.primary.zero_grad(set_to_none=set_to_none)
        self.matrix.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        # a profiler range around both parts' own ("Optimizer.step#...")
        with torch.profiler.record_function("SplitOptimizer.step"):
            self.primary.step()
            self.matrix.step()

    def state_dict(self) -> Dict[str, Any]:
        return {"primary": self.primary.state_dict(), "matrix": self.matrix.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        load_optimizer_state(self.primary, state["primary"])
        load_optimizer_state(self.matrix, state["matrix"])


# --------------------------------------------------------------------------
# labels, the factory and the Scion re-init, JAX :189-294
# --------------------------------------------------------------------------


def _named(params: Params) -> Named:
    """(name, parameter) pairs; a bare parameter gets the name "" (no split
    by name, and the JAX layout is taken to be the port's)."""
    return [item if isinstance(item, tuple) else ("", item) for item in params]


def param_labels(named: Params) -> Dict[str, str]:
    """JAX's split rule on the port's parameter names: "emb" in the
    lower-cased name or fewer than two dimensions -> "primary"
    (optimizer1); otherwise "encoder" in the name -> "matrix" (optimizer2);
    the rest "primary"."""
    labels = {}
    for name, p in _named(named):
        path = name.lower()
        if "emb" in path or p.ndim < 2:
            labels[name] = "primary"
        elif "encoder" in path:
            labels[name] = "matrix"
        else:
            labels[name] = "primary"
    return labels


def _layout_groups(named: Named) -> List[Dict[str, Any]]:
    """The parameters in the JAX layout, then those stored transposed, each a
    param group with its `transposed` flag (empty groups left out)."""
    groups = []
    for flag in (False, True):
        params = [p for name, p in named if transposed_from_jax(name) == flag]
        if params:
            groups.append({"params": params, "transposed": flag})
    return groups


def build_single(cfg: OptimizerConfig, params: Params, lr: float,
                 fused: bool = False) -> torch.optim.Optimizer:
    """One optimizer of `cfg.kind` over `params` at rate `lr`."""
    named = _named(params)
    plain = [p for _, p in named]
    if cfg.kind in ("muon", "scion", "scion_light"):
        # a tensor rate on every device
        rate = torch.tensor([lr], dtype=torch.float32, device=plain[0].device)
        if cfg.kind == "muon":
            return Muon(_layout_groups(named), lr=rate, momentum=cfg.momentum,
                        nesterov=cfg.nesterov, ns_steps=cfg.ns_steps,
                        weight_decay=cfg.weight_decay)
        return Scion(_layout_groups(named), lr=rate, momentum=cfg.momentum, norm=cfg.norm,
                     scale=cfg.scale, unconstrained=cfg.unconstrained, ns_steps=cfg.ns_steps)
    rate: Any = lr
    extra: Dict[str, Any] = {}
    if fused:
        rate = torch.tensor([lr], dtype=torch.float32, device=plain[0].device)
        extra = {"fused": True}
    if cfg.kind == "adamw":
        opt = torch.optim.AdamW(
            plain, lr=rate, betas=tuple(cfg.betas), eps=cfg.eps,
            weight_decay=cfg.weight_decay, capturable=fused, **extra,
        )
        # the eager steps run uncaptured on purpose: capturable changes nothing
        # in the fused update, so torch's one-time warning about it is noise
        opt._warned_capturable_if_run_uncaptured = True
        return opt
    if cfg.kind == "sgd":
        return torch.optim.SGD(plain, lr=rate, momentum=cfg.momentum, **extra)
    raise ValueError(f"Unknown optimizer kind {cfg.kind}")


def build_optimizer(
    opt1: OptimizerConfig,
    opt2: Optional[OptimizerConfig],
    params: Params,
    lr1: float,
    lr2: Optional[float] = None,
    fused: bool = False,
) -> Union[torch.optim.Optimizer, SplitOptimizer]:
    """optimizer1 over every parameter; with `opt2.enabled`, a
    `SplitOptimizer` of optimizer1 over the "primary" parameters and
    optimizer2 (at lr2, default `opt2.lr`) over the "matrix" ones, which
    needs the parameters' names (`model.named_parameters()`)."""
    named = _named(params)
    if opt2 is None or not opt2.enabled:
        return build_single(opt1, named, lr1, fused=fused)
    if any(not name for name, _ in named):
        raise ValueError("optimizer2 splits the parameters by name: pass (name, parameter) "
                         "pairs, as model.named_parameters() gives them")
    labels = param_labels(named)
    return SplitOptimizer(
        build_single(opt1, [(n, p) for n, p in named if labels[n] == "primary"], lr1, fused),
        build_single(opt2, [(n, p) for n, p in named if labels[n] == "matrix"],
                     opt2.lr if lr2 is None else lr2, fused),
    )


@torch.no_grad()
def scion_init_params(named: Params, cfg: OptimizerConfig, generator: torch.Generator) -> None:
    """JAX's `scion_init_params` in place on the "matrix" parameters: a
    matrix gets an orthogonal init in its JAX layout times
    (d_out/d_in)^0.5 * cfg.scale (d_out, d_in the layout's rows and columns),
    a vector zeros. The draws come from `generator`, on the CPU."""
    named = _named(named)
    labels = param_labels(named)
    for name, p in named:
        if labels[name] != "matrix":
            continue
        if p.ndim < 2:
            p.zero_()
            continue
        shape = tuple(p.t().shape) if transposed_from_jax(name) else tuple(p.shape)
        d_out, d_in = shape[0], math.prod(shape[1:])
        w = torch.empty((d_out, d_in), dtype=torch.float32)
        torch.nn.init.orthogonal_(w, generator=generator)
        w = (w * ((d_out / d_in) ** 0.5) * cfg.scale).reshape(shape)
        p.copy_(w.t() if transposed_from_jax(name) else w)


# --------------------------------------------------------------------------
# learning rates and state
# --------------------------------------------------------------------------


def rate_groups(optimizer: Any) -> Tuple[list, list]:
    """(the groups at lr1, the groups at lr2): a split optimizer's (and the
    lazy table optimizer's, train/lazy_embedding.py) own, else every group
    at lr1."""
    own = getattr(optimizer, "rate_groups", None)
    return own() if own is not None else (optimizer.param_groups, [])


def _fill(groups: Sequence[Dict[str, Any]], lr: float) -> None:
    for group in groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def set_lr(optimizer: Any, lr1: float, lr2: Optional[float] = None) -> None:
    """optimizer1's groups to `lr1` and optimizer2's to `lr2` (kept where
    None): filled in place where the rate is a tensor (a captured step reads
    it there), assigned where it is a float."""
    first, second = rate_groups(optimizer)
    _fill(first, lr1)
    if lr2 is not None:
        _fill(second, lr2)


def load_optimizer_state(optimizer: Any, state: Dict[str, Any]) -> None:
    """`optimizer.load_state_dict(state)`, keeping what this optimizer was
    built with: its own learning-rate tensor (holding the checkpoint's rate),
    `fused` and `capturable`, and a fused optimizer's step counts as float32
    on the parameters' device. A checkpoint written by the other kind of
    optimizer (float rate, host step counts) then loads as well. A split
    optimizer (and the lazy table optimizer) loads each part so."""
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer.load_state_dict(state)
        return
    kept = [
        {key: group[key] for key in ("lr", "fused", "capturable") if key in group}
        for group in optimizer.param_groups
    ]
    optimizer.load_state_dict(state)
    for group, own in zip(optimizer.param_groups, kept):
        rate = float(group["lr"])
        if isinstance(own["lr"], torch.Tensor):
            own["lr"].fill_(rate)
        else:
            own["lr"] = rate
        group.update(own)
        if not group.get("fused"):
            continue
        for p in group["params"]:
            entry = optimizer.state.get(p)
            if entry and isinstance(entry.get("step"), torch.Tensor):
                entry["step"] = entry["step"].to(device=p.device, dtype=torch.float32)


@torch.no_grad()
def load_jax_momentum(optimizer: Any, named: Params, momentum: Mapping[str, Any]) -> None:
    """JAX's `MuonState.momentum` / `ScionState.momentum` (a flax-shaped tree
    of numpy arrays, as `optax.multi_transform` holds it: the leaves of the
    other label are placeholders without a shape and are skipped) into the
    momentum buffers of the optimizer's Muon or Scion part, `o/kernel`
    transposed as the weights are."""
    part = optimizer.matrix if isinstance(optimizer, SplitOptimizer) else optimizer
    if not isinstance(part, (Muon, Scion)):
        raise ValueError(f"no Muon or Scion part in {type(optimizer).__name__}")
    params = dict(_named(named))
    owned = {p for group in part.param_groups for p in group["params"]}
    for key, value in jax_tree_to_state_dict(momentum).items():
        p = params[key]
        if p not in owned:
            raise ValueError(f"{key} is not stepped by the {type(part).__name__} part")
        part.state[p]["momentum_buffer"] = value.to(device=p.device, dtype=p.dtype).clone()

