"""The lazy (sparse-row) AdamW of the item table (`embedding.lazy_update`).

Port of mygenerativerecommenders_tpu/train/lazy_embedding.py: `lazy_applicable`
(:76-95), the table split (:98-115), `lazy_adamw_update` (:118-175),
`make_lazy_parts` (:198-283) and `make_lazy_train_step` (:291-357). An
algorithm change (torch `SparseAdam` semantics plus decoupled decay on the
touched rows), opt-in, as in JAX: the loss is the shared-negatives loss, so
a step touches the B*N history slots and the R shared negatives alone,
K = B*N + R rows.

- The item table stays the model's parameter (`embeddings._item_emb.weight`,
  the same `state_dict` key) but is left out of the fused AdamW's groups;
  `LazyEmbeddingAdamW` holds that AdamW and the table's own state, `mv`
  [V, 2D] (the first and second moments packed side by side) and a global
  int step count.
- The loss reads `rows = table[ids_all]` as a leaf that requires grad
  (`LazyEmbeddingAdamW.rows`), so autograd gives the factored [K, D]
  gradient and never a dense [V, D] one.
- The update dedups the K ids at a static shape: `torch.sort`, a
  first-of-run mask, `cumsum` into segment numbers and `index_add_` of the
  rows' gradients into [K, D]; the unique ids fill the first slots and the
  rest are unused. No `torch.unique` or `nonzero`, whose host sync would
  break a CUDA graph's capture. JAX drops the unused slots with
  `mode="drop"`: here their table update is an add of -0.0 (x + -0.0 is x,
  bit for bit, for every x) into row 0, and their moment writes go to a
  scratch row behind the V rows of `mv`. Rows not touched stay bit for bit
  unchanged; row 0 (padding) is a touched row whenever it is in `ids_all`,
  as in JAX.

Both the eager step and the k-step CUDA graph (train/graphs.py) run it; the
graph's warm-up steps are undone with the table's state too
(`LazyEmbeddingAdamW.state_tensors`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.configs import Config, OptimizerConfig
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.parallel.process_group import gather_rows_of, replica_mean_
from mygenerativerecommenders_tpu_torch.train import task_retrieval
from mygenerativerecommenders_tpu_torch.train.optimizers import (
    build_optimizer,
    load_optimizer_state,
    rate_groups,
)

TABLE_KEY = "embeddings._item_emb.weight"


def lazy_applicable(cfg: Config, raise_on_error: bool = True) -> bool:
    """The configurations under which the touched-row set is the sparse
    (past_ids, shared negatives) pair the lazy update relies on."""
    m = cfg.model
    problems = []
    if not m.loss.shared_negatives or m.loss.kind != "sampled_softmax":
        problems.append("loss.shared_negatives with kind=sampled_softmax")
    if m.sampler.kind != "local":
        problems.append("sampler.kind=local")
    if m.similarity.kind != "dot_product":
        problems.append("similarity.kind=dot_product")
    if m.embedding.kind != "local":
        problems.append("embedding.kind=local")
    if cfg.optimizer1.kind != "adamw":
        problems.append("optimizer1.kind=adamw")
    if problems and raise_on_error:
        raise ValueError("embedding.lazy_update requires: " + ", ".join(problems))
    return not problems


def split_table(model: GenerativeRecommender) -> Tuple[torch.nn.Parameter, list]:
    """(table, rest): the item table, and every other parameter of the model
    as (name, parameter) pairs."""
    named = dict(model.named_parameters())
    extra = [name for name in named if name.startswith("embeddings.") and name != TABLE_KEY]
    if extra:
        raise ValueError(
            f"lazy_update expects a plain local table; extra embedding params {extra} "
            "(use embedding.kind=local)"
        )
    table = named.pop(TABLE_KEY)
    return table, list(named.items())


@torch.no_grad()
def lazy_adamw_update(
    table: torch.Tensor,  # [V, D], updated in place
    mv: torch.Tensor,  # [V + 1, 2D] moments, the last row a scratch row; in place
    count: torch.Tensor,  # 0-d int step count, incremented in place
    ids: torch.Tensor,  # [K] touched row ids (duplicates allowed)
    row_grads: torch.Tensor,  # [K, D] per-slot gradients
    lr: Any,  # float, or a 1-element tensor
    betas: Tuple[float, float],
    eps: float,
    weight_decay: float,
) -> None:
    """AdamW on the touched rows only: the gradients of duplicate ids summed
    (as the dense scatter-add of the gather's transpose sums them), the
    moments of the unique rows moved, bias correction from the global count
    (torch SparseAdam), then the decoupled decay of the touched rows."""
    b1, b2 = betas
    v_rows, d = table.shape
    k = ids.shape[0]
    sid, order = torch.sort(ids.long(), stable=True)
    first = torch.ones(k, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1  # [K] the unique id each slot adds into
    gsum = torch.zeros((k, d), dtype=row_grads.dtype, device=row_grads.device)
    gsum.index_add_(0, seg, row_grads[order])
    # slot j < n_unique holds its run's id (every slot of a run writes the
    # same value); the others keep the sentinel V
    uids = torch.full((k,), v_rows, dtype=torch.long, device=ids.device).scatter_(0, seg, sid)
    used = uids < v_rows  # [K]
    mv_rows = mv[uids]  # the unused slots read the scratch row V
    p_rows = table[torch.where(used, uids, 0)]
    count += 1
    mv_new = torch.cat([b1 * mv_rows[:, :d], b2 * mv_rows[:, d:]], dim=1) + torch.cat(
        [(1.0 - b1) * gsum, (1.0 - b2) * gsum * gsum], dim=1
    )
    c = count.to(torch.float32)
    m_hat = mv_new[:, :d] / (1.0 - b1**c)
    v_hat = mv_new[:, d:] / (1.0 - b2**c)
    upd = -lr * (m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p_rows)
    # an unused slot adds -0.0 to row 0: x + -0.0 is x for every x
    table.index_add_(0, torch.where(used, uids, 0), torch.where(used[:, None], upd, -0.0))
    mv.index_copy_(0, uids, mv_new)  # the unused slots' writes land in the scratch row


class LazyEmbeddingAdamW:
    """The trainer's optimizer under `embedding.lazy_update`: `rest`, the
    (fused on the card) AdamW over every parameter but the item table (with
    `optimizer2.enabled` the split optimizer, AdamW and the matrix optimizer,
    as JAX's lazy step builds it), and the lazy update of the table, at
    optimizer1's learning rate (a tensor on the card, which a CUDA graph
    reads in place). `rows(ids)` is the loss's one lookup of the table;
    `step()` updates `rest`, then the rows looked up since `zero_grad()`.

    `param_groups`, `state` and `rate_groups()` are `rest`'s (`set_lr`, and
    the snapshot of train/graphs.py read them); `state_tensors()` adds the
    table's state.
    `state_dict()` holds `rest`'s state dict, `mv` [V, 2D] and the count."""

    def __init__(self, rest: torch.optim.Optimizer, table: torch.nn.Parameter,
                 opt1: OptimizerConfig):
        self.rest = rest
        self.table = table
        v, d = table.shape
        self._mv = torch.zeros((v + 1, 2 * d), dtype=table.dtype, device=table.device)
        self.count = torch.zeros((), dtype=torch.int64, device=table.device)
        self.betas = (float(opt1.betas[0]), float(opt1.betas[1]))
        self.eps = float(opt1.eps)
        self.weight_decay = float(opt1.weight_decay)
        self._touched: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def mv(self) -> torch.Tensor:
        """[V, 2D]: the first moments in [:, :D], the second in [:, D:]."""
        return self._mv[:-1]

    @property
    def param_groups(self):
        return self.rest.param_groups

    @property
    def state(self):
        return self.rest.state

    def rate_groups(self):
        return rate_groups(self.rest)

    def state_tensors(self) -> Sequence[torch.Tensor]:
        return [self._mv, self.count]

    def rows(self, ids: torch.Tensor) -> torch.Tensor:
        """table[ids] as a leaf that requires grad: the step updates these."""
        rows = self.table.detach()[ids.long()].requires_grad_()
        self._touched = (ids, rows)
        return rows

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.rest.zero_grad(set_to_none=set_to_none)
        self._touched = None

    def step(self) -> None:
        if self._touched is None or self._touched[1].grad is None:
            raise RuntimeError("LazyEmbeddingAdamW.step: no table rows with a gradient")
        # a profiler range, as torch.optim's step has one ("Optimizer.step#...")
        with torch.profiler.record_function("LazyEmbeddingAdamW.step"):
            self.rest.step()
            ids, grads = self._touched[0], self._touched[1].grad
            # within a data-parallel step: every data index's touched rows,
            # the global batch's K = data * (B*N + R) that JAX's update
            # dedups; under TP or the ring the table is replicated over the
            # model and sp groups, whose rows' gradients are averaged first,
            # as the step averages every replicated leaf's
            ids, grads = gather_rows_of(ids), gather_rows_of(replica_mean_(grads))
            lazy_adamw_update(
                self.table.data, self._mv, self.count, ids, grads,
                rate_groups(self.rest)[0][0]["lr"], self.betas, self.eps, self.weight_decay,
            )
        self._touched = None

    def state_dict(self) -> Dict[str, Any]:
        return {"rest": self.rest.state_dict(), "mv": self.mv, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Into this optimizer's own tensors: `rest` by `load_optimizer_state`,
        `mv` and the count copied in place."""
        load_optimizer_state(self.rest, state["rest"])
        self.mv.copy_(state["mv"])
        self.count.copy_(state["count"])


def init_lazy_optimizer(
    cfg: Config, model: GenerativeRecommender, fused: bool = False
) -> LazyEmbeddingAdamW:
    """The JAX package's `init_lazy_opt_state`: AdamW (and with
    `optimizer2.enabled` the matrix optimizer beside it) over the non-table
    parameters and zeroed moments and count for the table."""
    lazy_applicable(cfg)
    table, rest = split_table(model)
    opt2 = cfg.optimizer2 if cfg.optimizer2.enabled else None
    return LazyEmbeddingAdamW(
        build_optimizer(cfg.optimizer1, opt2, rest, cfg.optimizer1.lr, fused=fused),
        table, cfg.optimizer1,
    )


def make_lazy_parts(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    packed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Callable[..., torch.Tensor], Callable[..., torch.Tensor],
           Callable[..., Tuple[int, ...]], Callable[..., torch.Tensor]]:
    """(ids_fn, loss_rows_fn, negatives_shape, draw_negatives).

    ids_fn(batch, neg_offsets) -> [K] the ids the shared-negatives loss
    looks up this step, in lookup order: the post-scatter past_ids (B*N
    slots, packed: the row's tokens), then the R shared negatives.

    loss_rows_fn(rows, batch, neg_offsets) -> the shared-negatives loss of
    train/task_retrieval.py with every table lookup a slice of `rows`
    (rows = table[ids_fn(batch, neg_offsets)]).

    negatives_shape and draw_negatives are that loss's ([R] offsets, drawn
    from `generator`)."""
    lazy_applicable(cfg)
    sampler = task_retrieval.make_sampler(cfg)
    t = cfg.model.loss.temperature
    _, negatives_shape, draw_negatives = task_retrieval._loss_parts(
        model, cfg, all_item_ids, packed, generator
    )
    device = next(model.parameters()).device
    catalog = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int64), device=device)
    seq_and_past_ids, encode_for_loss = task_retrieval.make_encoder(model, cfg, packed)

    def ids_fn(batch: Dict[str, torch.Tensor], neg_offsets: torch.Tensor) -> torch.Tensor:
        _, past_ids = seq_and_past_ids(batch)
        return torch.cat([past_ids.reshape(-1).long(), catalog[neg_offsets.long()]])

    def loss_rows_fn(
        rows: torch.Tensor, batch: Dict[str, torch.Tensor], neg_offsets: torch.Tensor
    ) -> torch.Tensor:
        neg_ids = catalog[neg_offsets.long()]
        # encode_for_loss looks up exactly ids_fn's ids, in its order: `rows`
        outputs, sup_ids, sup_emb, weights, neg_rows = encode_for_loss(
            batch, extra_ids=neg_ids, lookup=lambda ids: rows
        )
        return task_retrieval.shared_negatives_loss(
            sampler, t, outputs, sup_ids, sup_emb, weights, neg_ids,
            sampler.normalize_embeddings(neg_rows),
        )

    return ids_fn, loss_rows_fn, negatives_shape, draw_negatives


def make_lazy_train_step(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    optimizer: LazyEmbeddingAdamW,
    steps: int = 1,
    packed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """task_retrieval.make_train_step's step with the item table updated
    lazily, under the same signatures: steps=1 eager, steps=k > 1 one CUDA
    graph replay a step on the card. The shared negatives' [R] offsets are
    the drawn input `neg_offsets`. Over a data-parallel group every rank
    applies the update of the global batch's touched rows (`step`)."""
    if not isinstance(optimizer, LazyEmbeddingAdamW):
        raise ValueError(
            "embedding.lazy_update trains with the optimizer of init_lazy_optimizer, "
            f"not {type(optimizer).__name__}"
        )
    ids_fn, loss_rows_fn, negatives_shape, draw_negatives = make_lazy_parts(
        model, cfg, all_item_ids, packed, generator
    )

    def loss_fn(
        batch: Dict[str, torch.Tensor], neg_offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if neg_offsets is None:
            neg_offsets = draw_negatives(batch)
        rows = optimizer.rows(ids_fn(batch, neg_offsets))
        return loss_rows_fn(rows, batch, neg_offsets)

    drawn = task_retrieval.DrawnInput(
        task_retrieval._OFFSETS, negatives_shape, torch.int32,
        lambda batch, out: draw_negatives(batch, out=out),
    )
    return task_retrieval.train_step_from_loss(model, optimizer, loss_fn, steps, drawn)
