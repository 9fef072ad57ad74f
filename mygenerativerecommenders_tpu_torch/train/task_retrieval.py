"""The retrieval task: the training loss and step, the eval step and its
candidate matrix.

Port of mygenerativerecommenders_tpu/train/task_retrieval.py: `make_loss_fn`
with `make_sampler`, `ids_to_offsets`, `encode_for_loss` (padded and packed)
and its losses, the dense-catalog `loss_fn_dense`, the per-sample gather
`loss_fn` (sampled softmax or BCE, the local or the in-batch sampler) and
`loss_fn_shared` (:54-321), `make_train_step`
(:315-394) with the optimizer step and its k-step form
`train_step_from_loss` (:326-379, shared with the ranking task; with
`embedding.lazy_update` the step of train/lazy_embedding.py),
`index_sharded_on` (:400-420), `make_candidate_fn` (:423-501, replicated
or row-sharded, exact or int8), `make_eval_step` (:504-625) and
`make_packed_eval_step` (:627-730), each with its k-batch form. Serving and
the trainer's eval share the eval step.

The training step is: scatter the target into the history at position
`length`, embed, forward (dropout on under `model.train()`), supervise
position p with the id at p+1, draw R negative catalog offsets per position
(or R for the whole step, shared), and take the sampled-softmax loss: through
the dense-catalog path (ops/dense_negatives.py) where the JAX package takes
it (`loss_variant`: the [B*T, X] count under its 3e9 gate), else by
gathering each position's negatives from the table. The in-batch sampler
draws each position's R negatives from the batch's own valid ids instead
(models/negatives.py; its uniforms are the step's drawn input), and
`loss.kind=bce` takes one negative a position (R = 1) and the binary
cross-entropy; both take the gather route, as in the JAX package. A packed batch
(data/packing.py) has its targets inline as each segment's last token:
nothing is scattered, and position p supervises the id at p+1 only where both
lie in one segment. With `index.quantize=int8` the candidates are a
`QuantizedCatalog` (ops/quantized_topk.py): the eval step pre-ranks on the
int8 rows and re-scores on the exact ones. With `index.sharded` on (a
sharded embedding kind) the candidates are the padded catalog's rows,
row-sharded over the shards of the table, and the eval step takes the
sharded top-k (parallel/topk_sharded.py). On cuda the k-step and k-batch
forms replay CUDA graphs of the whole step (train/graphs.py); one step a call
stays eager.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from mygenerativerecommenders_tpu_torch.configs import Config
from mygenerativerecommenders_tpu_torch.models.losses import (
    _weighted_mean,
    bce_loss,
    sampled_softmax_loss,
)
from mygenerativerecommenders_tpu_torch.models.model import GenerativeRecommender
from mygenerativerecommenders_tpu_torch.models.negatives import (
    InBatchNegativesSampler,
    LocalNegativesSampler,
    NegativesSampler,
)
from mygenerativerecommenders_tpu_torch.ops.dense_negatives import (
    sampled_softmax_dense_neg_lse,
)
from mygenerativerecommenders_tpu_torch.ops.sequence import (
    get_current_embeddings,
    scatter_at_lengths,
)
from mygenerativerecommenders_tpu_torch.ops.quantized_topk import (
    QuantizedCatalog,
    mips_top_k_int8,
    quantize_catalog,
)
from mygenerativerecommenders_tpu_torch.ops.topk import mips_top_k
from mygenerativerecommenders_tpu_torch.parallel.embedding_sharding import (
    OneDeviceShards,
    round_up,
)
from mygenerativerecommenders_tpu_torch.parallel.process_group import (
    GradBuffer,
    gather_rows_of,
    model_shards,
    started,
)
from mygenerativerecommenders_tpu_torch.parallel.topk_sharded import (
    sharded_mips_top_k,
    sharded_mips_top_k_int8,
)
from mygenerativerecommenders_tpu_torch.train.graphs import StepGraphs, training_state
from mygenerativerecommenders_tpu_torch.train.optimizers import set_lr
from mygenerativerecommenders_tpu_torch.utils.features import (
    SequenceBatch,
    packed_seq_features,
    seq_features_from_batch,
)


# the static inputs that a graphed step's caller fills itself (train/graphs.py):
# the negatives' offsets (the in-batch sampler's uniforms), and the candidates
# (the exact rows; with an int8 index also its int8 rows and scales)
_OFFSETS, _UNIFORMS, _CANDIDATES = "neg_offsets", "neg_uniforms", "candidates"
_CANDIDATES_Q, _CANDIDATES_SCALES = "candidates_q", "candidates_scales"
_CANDIDATE_KEYS = (_CANDIDATES, _CANDIDATES_Q, _CANDIDATES_SCALES)

# what the eval step scores against: the exact [X, D] rows, or the int8 index
Candidates = Union[torch.Tensor, QuantizedCatalog]


def candidate_inputs(candidates: Candidates) -> Dict[str, torch.Tensor]:
    """The candidates as named tensors, the inputs a graph binds: the exact
    rows under "candidates" (generation decodes against them), and an int8
    index's rows and scales beside them."""
    if isinstance(candidates, QuantizedCatalog):
        return {_CANDIDATES: candidates.exact, _CANDIDATES_Q: candidates.q,
                _CANDIDATES_SCALES: candidates.scales}
    return {_CANDIDATES: candidates}


def candidates_from(inputs: Dict[str, torch.Tensor]) -> Candidates:
    """`candidate_inputs`' inverse."""
    if _CANDIDATES_Q in inputs:
        return QuantizedCatalog(inputs[_CANDIDATES_Q], inputs[_CANDIDATES_SCALES],
                                inputs[_CANDIDATES])
    return inputs[_CANDIDATES]


def _check_packable(cfg: Config) -> None:
    """The preconditions of packed batches (the JAX package's, :80-96)."""
    m = cfg.model
    problems = []
    if m.task != "retrieval":
        problems.append("model.task=retrieval")
    if m.preprocessor.kind != "learnable_positional":
        problems.append("preprocessor.kind=learnable_positional")
    if m.encoder.kind != "hstu" or m.encoder.normalization not in ("rel_bias", "hstu_rel_bias"):
        problems.append("encoder.kind=hstu with rel_bias normalization")
    if m.encoder.sp_shards > 1:
        problems.append("encoder.sp_shards=1 (packing replaces the ring)")
    if problems:
        raise ValueError("data.pack_sequences requires: " + ", ".join(problems))


def make_sampler(cfg: Config) -> NegativesSampler:
    s = cfg.model.sampler
    if s.kind == "local":
        return LocalNegativesSampler(l2_norm=s.l2_norm, l2_norm_eps=s.l2_norm_eps)
    if s.kind == "in_batch":
        return InBatchNegativesSampler(
            l2_norm=s.l2_norm, l2_norm_eps=s.l2_norm_eps, dedup_embeddings=s.dedup_embeddings
        )
    raise ValueError(f"Unknown sampler kind {s.kind}")


def make_ids_to_offsets(
    all_item_ids: np.ndarray, device: torch.device
) -> Callable[[torch.Tensor], torch.Tensor]:
    """ids_to_offsets(ids) -> each id's row in the catalog, -1 for ids outside
    it (padding): the accidental-hit mask compares offsets and gathers no
    [B, T, R] ids."""
    table_np = np.full(int(np.max(all_item_ids)) + 1, -1, dtype=np.int32)
    table_np[np.asarray(all_item_ids)] = np.arange(len(all_item_ids), dtype=np.int32)
    table = torch.as_tensor(table_np, device=device)

    def ids_to_offsets(ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        inside = (ids >= 0) & (ids < table.shape[0])
        return torch.where(inside, table[ids.clamp(0, table.shape[0] - 1)], -1)

    return ids_to_offsets


def make_loss_fn(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    packed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """Builds loss_fn(batch, neg_offsets=None) -> scalar loss: the
    dense-catalog loss, the per-sample gather loss or the shared-negatives
    loss, chosen as the JAX package chooses (`loss_variant`); with the
    in-batch sampler loss_fn(batch, neg_uniforms=None).

    The negatives are drawn from `generator` (on the model's device; None:
    the device's default), unless the caller hands in `neg_offsets` itself
    ([B, N-1, R], or [R] shared; R = 1 for BCE), or the in-batch sampler's
    uniforms `neg_uniforms` ([B, N-1, R] float32), as the parity tests do
    with the JAX package's draw. packed=True takes PackedBatchLoader batches; the
    supervised (position, target) pairs are those of the padded layout for
    the same examples. `loss_fn.variant` names the loss."""
    return _loss_parts(model, cfg, all_item_ids, packed, generator)[0]


def loss_variant(cfg: Config, num_catalog: int) -> str:
    """"shared" (loss.shared_negatives), "dense" (the dense-catalog path:
    loss.dense_catalog_negatives=true, or auto under the gate) or "gather"
    (the per-sample gather loss), for a retrieval loss over a catalog of
    `num_catalog` items (JAX :97-134, :314-321). BCE and the in-batch
    sampler take the gather loss."""
    loss_cfg = cfg.model.loss
    if loss_cfg.kind not in ("sampled_softmax", "bce"):
        raise ValueError(f"Unknown retrieval loss {loss_cfg.kind}")
    # valid exactly when the negative logits are plain dot products against
    # normalized catalog rows
    applicable = (
        loss_cfg.kind == "sampled_softmax"
        and cfg.model.sampler.kind == "local"
        and cfg.model.similarity.kind == "dot_product"
    )
    if loss_cfg.shared_negatives:
        if not applicable:
            raise ValueError(
                "loss.shared_negatives requires sampled_softmax + local "
                "sampler + dot_product similarity"
            )
        return "shared"
    # auto also gates on the [B*T, X] uint8 count footprint, as the JAX
    # package does with its Pallas kernels (3e9 elements, ~2.7 GB)
    dense_neg = str(loss_cfg.dense_catalog_negatives).lower()
    bt_rows = cfg.data.batch_size * (
        cfg.data.max_sequence_length + cfg.model.gr_output_length + 1
    )
    x_pad = ((num_catalog + 127) // 128) * 128
    fits = bt_rows * x_pad <= 3e9
    if dense_neg in ("true", "1", "yes") and not applicable:
        raise ValueError(
            "loss.dense_catalog_negatives=true requires sampled_softmax + "
            "local sampler + dot_product similarity"
        )
    if applicable and (dense_neg in ("true", "1", "yes") or (dense_neg == "auto" and fits)):
        return "dense"
    return "gather"


def make_encoder(
    model: GenerativeRecommender, cfg: Config, packed: bool
) -> Tuple[Callable[..., Tuple[SequenceBatch, torch.Tensor]], Callable[..., tuple]]:
    """(seq_and_past_ids, encode_for_loss), the preamble every retrieval
    loss shares (JAX `encode_for_loss`, :157-206).

    seq_and_past_ids(batch) -> (features, past_ids [B, N]): the target
    scattered into the history at position `length` (a packed batch has its
    targets inline, and nothing is scattered).

    encode_for_loss(batch, extra_ids=None, lookup=None) -> (outputs
    [B, N-1, D], sup_ids [B, N-1], sup_emb [B, N-1, D], weights [B, N-1],
    extra_emb [*extra_ids.shape, D] or None): one lookup of the table for
    the flattened past_ids and, after them, `extra_ids` (the shared
    negatives), so that the backward builds one [V, D] table gradient, not
    one a lookup and their sum (`lookup(ids)`, default the model's table;
    the lazy step hands in the rows it gathered for those ids); then the forward (dropout on under
    `model.train()`), the shift-by-one supervision layout (outputs[:, :-1]
    against ids[:, 1:]) and the presence weights; packed, position p
    supervises the id at p+1 only where both lie in one segment."""
    max_out = cfg.model.gr_output_length + 1

    def seq_and_past_ids(batch: Dict[str, torch.Tensor]) -> Tuple[SequenceBatch, torch.Tensor]:
        if packed:
            seq = packed_seq_features(batch)
            return seq, seq.past_ids
        seq, target_ids, _ = seq_features_from_batch(batch, max_out)
        return seq, scatter_at_lengths(seq.past_ids, seq.past_lengths, target_ids)

    def encode_for_loss(
        batch: Dict[str, torch.Tensor],
        extra_ids: Optional[torch.Tensor] = None,
        lookup: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> Tuple[Optional[torch.Tensor], ...]:
        seq, past_ids = seq_and_past_ids(batch)
        ids = past_ids.reshape(-1).long()
        if extra_ids is not None:
            ids = torch.cat([ids, extra_ids.reshape(-1).long()])
        rows = (lookup or model.item_embeddings)(ids)
        n = past_ids.numel()
        input_embeddings = rows[:n].reshape(*past_ids.shape, -1)
        extra_emb = None
        if extra_ids is not None:
            extra_emb = rows[n:].reshape(*extra_ids.shape, -1)
        seq = seq._replace(past_ids=past_ids, past_embeddings=input_embeddings)
        encoded, _ = model(seq)  # [B, N, D]
        outputs = encoded[:, :-1, :]
        sup_ids = past_ids[:, 1:]
        sup_emb = input_embeddings[:, 1:, :]
        weights = (sup_ids != 0).to(torch.float32)
        if packed:
            seg = batch["seg_ids"]
            same_seg = (seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] >= 0)
            weights = weights * same_seg.to(torch.float32)
        elif "sample_weight" in batch:
            weights = weights * batch["sample_weight"][:, None]
        return outputs, sup_ids, sup_emb, weights, extra_emb

    return seq_and_past_ids, encode_for_loss


def shared_negatives_loss(
    sampler: LocalNegativesSampler,
    temperature: float,
    outputs: torch.Tensor,  # [B, T, D]
    sup_ids: torch.Tensor,  # [B, T]
    sup_emb: torch.Tensor,  # [B, T, D]
    weights: torch.Tensor,  # [B, T]
    neg_ids: torch.Tensor,  # [R]
    neg_emb: torch.Tensor,  # [R, D] normalized
) -> torch.Tensor:
    """The sampled softmax with one negative set shared by every position
    (JAX `loss_fn_shared`, :284-312): the negative logits are one
    [B, T, D] x [R, D] product (a library matmul, as JAX's einsum sits
    outside any Pallas kernel), accidental hits compared by id."""
    hits = sup_ids[..., None].long() == neg_ids.long()  # [B, T, R]
    pos_emb = sampler.normalize_embeddings(sup_emb)
    pos_logits = (outputs * pos_emb).sum(-1) / temperature
    neg_logits = torch.einsum("btd,rd->btr", outputs, neg_emb) / temperature
    return sampled_softmax_loss(pos_logits, neg_logits, hits, weights)


def _loss_parts(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    packed: bool,
    generator: Optional[torch.Generator],
) -> Tuple[Callable[..., torch.Tensor], Callable[..., Tuple[int, ...]],
           Callable[..., torch.Tensor]]:
    """(loss_fn, negatives_shape, draw_negatives): `make_loss_fn`'s loss, the
    shape of a batch's negative offsets ([B, N-1, R]; [R] shared), and the
    draw the loss makes when no offsets are handed in,
    draw_negatives(batch, out=None) -> int32 offsets; a graphed step makes
    it outside its graph, into `out`."""
    if packed:
        _check_packable(cfg)
    sampler = make_sampler(cfg)
    in_batch = isinstance(sampler, InBatchNegativesSampler)
    loss_cfg = cfg.model.loss
    variant = loss_variant(cfg, len(all_item_ids))
    num_neg = loss_cfg.num_to_sample if loss_cfg.kind == "sampled_softmax" else 1
    max_out = cfg.model.gr_output_length + 1
    t = loss_cfg.temperature
    device = next(model.parameters()).device
    catalog = torch.as_tensor(np.asarray(all_item_ids, dtype=np.int64), device=device)
    ids_to_offsets = make_ids_to_offsets(all_item_ids, device)
    seq_and_past_ids, encode_for_loss = make_encoder(model, cfg, packed)

    def negatives_shape(batch: Dict[str, torch.Tensor]) -> Tuple[int, ...]:
        """[B, N-1, R]: R draws for each supervised position, N the row
        (packed) or the history plus max_out; [R] for shared negatives."""
        if variant == "shared":
            return (num_neg,)
        rows, cols = batch["ids"].shape
        return rows, cols - 1 + (0 if packed else max_out), num_neg

    def draw_negatives(
        batch: Dict[str, torch.Tensor], out: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        *positions, draws = negatives_shape(batch)
        if in_batch:
            return sampler.uniforms(generator, tuple(positions), draws, device, out=out)
        return sampler.offsets_only(
            generator, tuple(positions), draws, len(all_item_ids), device, out=out
        )

    def gather_loss(outputs, sup_emb, weights, neg_emb, hits) -> torch.Tensor:
        """The per-sample loss on each position's gathered negatives
        [B, N-1, R, D] (JAX `loss_fn`'s scoring, :237-248): the sampled
        softmax, or BCE on the one negative."""
        pos_emb = sampler.normalize_embeddings(sup_emb)
        pos_logits = model.score(outputs, pos_emb[..., None, :])[..., 0] / t
        neg_logits = model.score(outputs, neg_emb) / t
        if loss_cfg.kind == "bce":
            return bce_loss(pos_logits, neg_logits[..., 0], hits[..., 0], weights)
        return sampled_softmax_loss(pos_logits, neg_logits, hits, weights)

    def loss_fn_dense(
        batch: Dict[str, torch.Tensor], neg_offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The dense-catalog path (ops/dense_negatives.py, JAX :252-282)."""
        outputs, sup_ids, sup_emb, weights, _ = encode_for_loss(batch)
        norm_catalog = sampler.normalize_embeddings(model.item_embeddings(catalog))
        if neg_offsets is None:
            neg_offsets = draw_negatives(batch)
        sup_offsets = ids_to_offsets(sup_ids)
        pos_emb = sampler.normalize_embeddings(sup_emb)
        pos_logits = (outputs * pos_emb).sum(-1) / t
        neg_lse = sampled_softmax_dense_neg_lse(
            outputs, norm_catalog, neg_offsets, sup_offsets, t
        )
        per_pos = torch.logaddexp(pos_logits, neg_lse) - pos_logits
        return _weighted_mean(per_pos, weights)

    def loss_fn(
        batch: Dict[str, torch.Tensor], neg_offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The per-sample gather loss (JAX `loss_fn`, :210-250): each
        position's R negatives gathered from the table and normalized,
        [B, N-1, R, D]; accidental hits compared by offset."""
        outputs, sup_ids, sup_emb, weights, _ = encode_for_loss(batch)
        if neg_offsets is None:
            neg_offsets = draw_negatives(batch)
        neg_emb = sampler.rows_at(neg_offsets, catalog, model.item_embeddings)
        hits = ids_to_offsets(sup_ids)[..., None] == neg_offsets
        return gather_loss(outputs, sup_emb, weights, neg_emb, hits)

    def loss_fn_in_batch(
        batch: Dict[str, torch.Tensor], neg_uniforms: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The gather loss on in-batch negatives (JAX `loss_fn`, :216-226):
        the pool of the batch's valid ids (after the target scatter, rows of
        sample_weight 0 left out; the global batch's under data parallel),
        each position's R ids drawn from it by the uniforms, looked up with
        the history in one table lookup; accidental hits compared by id."""
        _, past_ids = seq_and_past_ids(batch)
        presences = past_ids != 0
        if "sample_weight" in batch:
            presences = presences & (batch["sample_weight"][:, None] > 0)
        # within a data-parallel step the pool is the global batch's (JAX's
        # process_batch sees the global past_ids): one gather, absent ids as -1
        marked = gather_rows_of(torch.where(presences, past_ids, -1))
        pool, count = sampler.process_batch(marked.clamp(min=0), marked >= 0)
        if neg_uniforms is None:
            neg_uniforms = draw_negatives(batch)
        neg_ids = pool[sampler.offsets(neg_uniforms, count)]
        outputs, sup_ids, sup_emb, weights, neg_rows = encode_for_loss(batch, extra_ids=neg_ids)
        hits = sup_ids[..., None] == neg_ids
        return gather_loss(outputs, sup_emb, weights,
                           sampler.normalize_embeddings(neg_rows), hits)

    def loss_fn_shared(
        batch: Dict[str, torch.Tensor], neg_offsets: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """One negative set of R catalog items a step, shared by every
        position (JAX `loss_fn_shared`, :284-312)."""
        if neg_offsets is None:
            neg_offsets = draw_negatives(batch)
        neg_ids = catalog[neg_offsets.long()]  # [R]
        outputs, sup_ids, sup_emb, weights, neg_rows = encode_for_loss(batch, extra_ids=neg_ids)
        neg_emb = sampler.normalize_embeddings(neg_rows)
        return shared_negatives_loss(
            sampler, t, outputs, sup_ids, sup_emb, weights, neg_ids, neg_emb
        )

    chosen = loss_fn_in_batch if in_batch else {
        "dense": loss_fn_dense, "gather": loss_fn, "shared": loss_fn_shared}[variant]
    chosen.variant = variant
    # the keyword and dtype of the input the step draws (DrawnInput)
    chosen.drawn = (_UNIFORMS, torch.float32) if in_batch else (_OFFSETS, torch.int32)
    return chosen, negatives_shape, draw_negatives


class DrawnInput(NamedTuple):
    """An input of the loss that the step makes itself: `draw(batch, out)`
    fills `out`, a [shape(batch)] tensor of `dtype`, before each step. A
    graphed step draws it outside the graph, into a static buffer bound to
    the graph. The loss takes it as the keyword `name`."""

    name: str
    shape: Callable[[Dict[str, torch.Tensor]], Tuple[int, ...]]
    dtype: torch.dtype
    draw: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def train_step_from_loss(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[..., torch.Tensor],
    steps: int = 1,
    drawn: Optional[DrawnInput] = None,
) -> Callable[..., torch.Tensor]:
    """The optimizer step around `loss_fn(batch[, <drawn.name>=...])` (JAX
    :326-379).

    In a process that has started its data-parallel group
    (parallel/process_group.py: `started()`) the loss divides by the global
    weight sum, and between the backward and the optimizer step one
    all-reduce sums the gradients, views of one flat buffer, and the loss
    over the ranks: the psum of the JAX step over "data". The returned loss
    is that sum, the global batch's. Under NCCL on cuda the all-reduce is
    captured in the step's graph.

    steps=1: train_step(batch, lr1, lr2=None[, <drawn.name>=None]) -> the
    step's loss (detached). Sets the learning rates (`set_lr`: lr1 to
    optimizer1, lr2 to optimizer2 where there is one, as JAX passes both to
    every step), takes one step and updates the model's parameters in place,
    eagerly; the loss draws the drawn input itself unless the caller hands it
    in.

    steps=k > 1: train_steps(batches, lr1, lr2=None[, <drawn.name>=None]) ->
    [len(batches)] losses for up to k batches, one optimizer step each, in
    order; a drawn input handed in is then a list with one tensor per batch.
    On cuda each step is one replay of a CUDA graph of the whole step
    (train/graphs.py: one graph per batch shape, captured at the first step
    of that shape): the batch is copied into the graph's buffers and the
    drawn input is drawn (or copied) into its bound buffer, both outside the
    graph. Without a drawn input the graph binds nothing and nothing is made
    between replays. `train_steps.graphs` holds the graphs; it is None on the
    CPU, where the k steps run eagerly."""

    def one_step(batch, **inputs):
        optimizer.zero_grad(set_to_none=True)
        if group is not None:
            grads.prepare()
        loss = loss_fn(batch, **inputs)
        loss.backward()
        loss = loss.detach() if group is None else grads.all_reduce(group, loss)
        optimizer.step()
        return loss

    group, grads = started(), None
    if group is not None:
        grads = GradBuffer([p for g in optimizer.param_groups for p in g["params"]])

    if steps <= 1:
        def train_step(batch, lr1: float, lr2: Optional[float] = None, **inputs):
            set_lr(optimizer, lr1, lr2)
            return one_step(batch, **inputs)

        return train_step

    device = next(model.parameters()).device
    names = () if drawn is None else (drawn.name,)
    graphs = None
    # gloo's collectives cannot be captured: a gloo group on a card runs eagerly
    if device.type == "cuda" and (group is None or group.backend == "nccl"):
        def body(static: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor]:
            batch = {k: v for k, v in static.items() if k not in names}
            return (one_step(batch, **{k: static[k] for k in names}),)

        graphs = StepGraphs(
            body, "train", keep=training_state(list(model.parameters()), optimizer)
        )

    def train_steps(batches, lr1: float, lr2: Optional[float] = None,
                    **inputs) -> torch.Tensor:
        if not 0 < len(batches) <= steps:
            raise ValueError(f"{len(batches)} batches for a call of up to {steps} steps")
        if set(inputs) - set(names):
            raise TypeError(f"unexpected inputs {sorted(set(inputs) - set(names))}")
        set_lr(optimizer, lr1, lr2)
        given = {k: v for k, v in inputs.items() if v is not None}
        if graphs is None:
            return torch.stack([
                one_step(batch, **{k: v[i] for k, v in given.items()})
                for i, batch in enumerate(batches)
            ])
        losses = torch.empty(len(batches), dtype=torch.float32, device=device)
        for i, batch in enumerate(batches):
            bound = {}
            if drawn is not None:
                buf = graphs.buffer(drawn.name, drawn.shape(batch), drawn.dtype, device)
                if drawn.name in given:
                    buf.copy_(given[drawn.name][i])
                else:
                    drawn.draw(batch, buf)
                bound[drawn.name] = buf
            (loss,) = graphs(batch, bound=bound, tag=model.training)
            losses[i].copy_(loss)  # before the next replay overwrites it
        return losses

    train_steps.graphs = graphs
    return train_steps


def make_train_step(
    model: GenerativeRecommender,
    cfg: Config,
    all_item_ids: np.ndarray,
    optimizer: torch.optim.Optimizer,
    steps: int = 1,
    packed: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Callable[..., torch.Tensor]:
    """`train_step_from_loss` on the retrieval loss, whose negatives' offsets
    are its drawn input `neg_offsets` ([B, N-1, R] int32, [R] shared; one
    `torch.randint` on `generator`, the eager step's draw; with the in-batch
    sampler its uniforms `neg_uniforms`, [B, N-1, R] float32):

    steps=1: train_step(batch, lr1, lr2=None, neg_offsets=None) -> the step's loss.
    steps=k > 1: train_steps(batches, lr1, lr2=None, neg_offsets=None) -> [len(batches)]
    losses; `neg_offsets` is then a list with one tensor per batch.

    With `embedding.lazy_update` it is train/lazy_embedding.py's step, whose
    `optimizer` is that module's `LazyEmbeddingAdamW`."""
    if cfg.model.embedding.lazy_update:
        # imported here: that module builds on this one's loss parts
        from mygenerativerecommenders_tpu_torch.train.lazy_embedding import (
            make_lazy_train_step,
        )

        return make_lazy_train_step(
            model, cfg, all_item_ids, optimizer, steps, packed=packed, generator=generator
        )
    loss_fn, negatives_shape, draw_negatives = _loss_parts(
        model, cfg, all_item_ids, packed, generator
    )
    name, dtype = loss_fn.drawn
    drawn = DrawnInput(
        name, negatives_shape, dtype, lambda batch, out: draw_negatives(batch, out=out)
    )
    return train_step_from_loss(model, optimizer, loss_fn, steps, drawn)


SHARDED_KINDS = ("sharded_local", "sharded_a2a", "sharded_column", "sharded_2d")


def index_sharded_on(cfg: Config) -> bool:
    """Resolve index.sharded (JAX :400-420): the sharded candidate index
    engages for a sharded embedding kind with num_shards > 1."""
    s = str(cfg.model.index.sharded).lower()
    if s in ("false", "0", "no", "off"):
        return False
    applicable = (
        cfg.model.embedding.kind in SHARDED_KINDS and cfg.model.embedding.num_shards > 1
    )
    if s == "auto":
        return applicable
    if s in ("true", "1", "yes", "on"):
        if not applicable:
            raise ValueError(
                "index.sharded=true requires a sharded embedding kind with "
                "num_shards > 1"
            )
        return True
    raise ValueError(f"Unknown index.sharded {cfg.model.index.sharded!r}")


def index_shards(cfg: Config) -> Optional[OneDeviceShards]:
    """The shard group the candidate index is row-sharded over (the JAX
    trainer's "model" mesh axis): the started mesh's model group
    (parallel/process_group.py), else the shards run in turn on this device;
    None for the replicated index."""
    if not index_sharded_on(cfg):
        return None
    return model_shards() or OneDeviceShards(cfg.model.embedding.num_shards)


def _held_catalog(all_item_ids: np.ndarray, shards: Optional[OneDeviceShards],
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ids the candidates are looked up by, the ids of the index's
    rows held here): the catalog twice for the replicated index; the padded
    catalog and the held shards' rows of it for the sharded one."""
    ids = all_item_ids if shards is None else padded_catalog(all_item_ids, shards)
    catalog = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)
    if shards is None:
        return catalog, catalog
    return catalog, shards.own(catalog.view(shards.size, -1)).reshape(-1)


def padded_catalog(all_item_ids: np.ndarray, shards: OneDeviceShards) -> np.ndarray:
    """The catalog's ids padded with 0 to a multiple of the shards (JAX
    :442-446): the sharded index's row ids."""
    catalog = np.asarray(all_item_ids, dtype=np.int64)
    padded = np.zeros(round_up(len(catalog), shards.size), dtype=np.int64)
    padded[: len(catalog)] = catalog  # pad rows carry id 0
    return padded


def _check_index(cfg: Config) -> bool:
    """-> whether the index is int8 (index.quantize=int8)."""
    index = cfg.model.index
    if index.quantize not in ("", "none", "int8"):
        raise ValueError(f"Unknown index.quantize {index.quantize!r}")
    index_sharded_on(cfg)  # an unknown value, or true on a local kind, raises
    return index.quantize == "int8"


def make_candidate_fn(
    model: GenerativeRecommender, cfg: Config, all_item_ids: np.ndarray
) -> Callable[[], Candidates]:
    """candidates() -> [X, D]: the catalog's embeddings, normalized as the
    sampler normalizes them (sampler.l2_norm, sampler.l2_norm_eps); with
    index.quantize=int8 the `QuantizedCatalog` of those rows, the exact ones
    kept for re-scoring (JAX :489-500). With index.sharded on (JAX :439-482)
    the rows of the padded catalog, row-sharded over `index_shards(cfg)`:
    the group's held rows, [X_pad, D] on one device and the rank's [X_pad /
    R, D] over a process group, the pad rows zero (and in the int8 index
    zero rows of scale 1)."""
    quantized = _check_index(cfg)
    sampler = make_sampler(cfg)
    device = next(model.parameters()).device
    shards = index_shards(cfg)
    catalog, held = _held_catalog(all_item_ids, shards, device)

    def candidates() -> Candidates:
        rows = sampler.normalize_embeddings(model.item_embeddings(catalog))
        if shards is not None:
            # over a process group every rank looks up the whole catalog (a
            # collective of the sharded kinds) and keeps its shard's rows
            rows = shards.own(rows.view(shards.size, -1, rows.shape[-1])).flatten(0, 1)
            rows = torch.where(held[:, None] > 0, rows, 0.0)
        return quantize_catalog(rows, keep_exact=True) if quantized else rows

    return candidates


def _eval_many(model: torch.nn.Module, eval_step: Callable, steps: int) -> Callable:
    """eval_steps(batches, candidates=None) -> each output of
    eval_step(batch[, candidates]) stacked over up to `steps` batches,
    [len(batches), ...] (the `lax.map` of JAX :504-625, :627-730). On cuda
    each batch is one replay of a CUDA graph of the eval step (one graph per
    batch shape, train/graphs.py), and the candidates (each tensor of
    `candidate_inputs`) are copied into the graphs' static buffers only when
    a call hands in other candidates than the last: once an epoch. Without
    candidates (the ranking task's step) the graphs bind nothing.
    `eval_steps.graphs` holds the graphs; None on the CPU, where the batches
    run eagerly."""
    device = next(model.parameters()).device
    graphs = None
    group = started()
    # gloo's collectives (the sharded index's merge, TP's) cannot be captured
    if device.type == "cuda" and (group is None or group.backend == "nccl"):
        def body(static: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
            batch = {k: v for k, v in static.items() if k not in _CANDIDATE_KEYS}
            extra = (candidates_from(static),) if _CANDIDATES in static else ()
            return tuple(eval_step(batch, *extra))

        graphs = StepGraphs(body, "eval")
    copied: list = [None]  # the candidates last copied into the buffers

    def eval_steps(
        batches, candidates: Optional[Candidates] = None
    ) -> Tuple[torch.Tensor, ...]:
        if not 0 < len(batches) <= steps:
            raise ValueError(f"{len(batches)} batches for a call of up to {steps}")
        extra = () if candidates is None else (candidates,)
        if graphs is None:
            outs = [eval_step(batch, *extra) for batch in batches]
            return tuple(torch.stack(parts) for parts in zip(*outs))
        bound = {}
        if candidates is not None:
            fresh = copied[0] is not candidates
            for name, t in candidate_inputs(candidates).items():
                bound[name] = graphs.buffer(name, t.shape, t.dtype, device)
                if fresh:
                    bound[name].copy_(t)
            copied[0] = candidates
        results: Tuple[torch.Tensor, ...] = ()
        for i, batch in enumerate(batches):
            outs = graphs(batch, bound=bound, tag=model.training)
            if not results:
                results = tuple(
                    torch.empty((len(batches),) + tuple(o.shape), dtype=o.dtype, device=device)
                    for o in outs
                )
            for result, o in zip(results, outs):
                result[i].copy_(o)  # before the next replay overwrites it
        return results

    eval_steps.graphs = graphs
    return eval_steps


def _top_k(
    cfg: Config, all_item_ids: np.ndarray, max_item_id: int, device: torch.device
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """top_k(queries [Q, D], candidates, invalid_ids) -> (ids [Q, k], scores
    [Q, k]): the exact scan, or with index.quantize=int8 the int8 pre-rank
    and exact re-score of `index.rescore_over_fetch * k` rows (JAX :591-602).
    With index.sharded on, the sharded top-k over the padded catalog's
    shards, exact or int8 (parallel/topk_sharded.py, JAX :529-578)."""
    quantized = _check_index(cfg)
    index = cfg.model.index
    k = min(index.k, len(all_item_ids))
    filter_past = index.filter_past_ids
    approx_recall = float(index.approx_top_k_recall)
    shards = index_shards(cfg)
    catalog = _held_catalog(all_item_ids, shards, device)[1]

    def top_k(queries, candidates: Candidates, invalid_ids):
        invalid = invalid_ids if filter_past else None
        if shards is not None:
            if quantized:
                return sharded_mips_top_k_int8(
                    shards, queries, candidates.q, candidates.scales, candidates.exact,
                    catalog, k=k, invalid_ids=invalid, over_fetch=index.rescore_over_fetch,
                )
            return sharded_mips_top_k(
                shards, queries, candidates, catalog, k=k, invalid_ids=invalid,
                approx_recall=approx_recall,
            )
        if quantized:
            return mips_top_k_int8(
                queries, candidates, catalog, k=k, invalid_ids=invalid,
                max_item_id=max_item_id, over_fetch=index.rescore_over_fetch,
            )
        return mips_top_k(
            queries, candidates, catalog, k=k, invalid_ids=invalid,
            max_item_id=max_item_id, approx_recall=approx_recall,
        )

    return top_k


def make_eval_step(
    model: GenerativeRecommender, cfg: Config, all_item_ids: np.ndarray, max_item_id: int,
    steps: int = 1,
) -> Callable[[Dict[str, torch.Tensor], Candidates], Tuple[torch.Tensor, torch.Tensor]]:
    """eval_step(batch, candidates) -> (top_k_ids [B, k], top_k_scores [B, k]).
    steps > 1: eval_steps(batches, candidates) over up to `steps` batches,
    each result [len(batches), B, k] (`_eval_many`: graphed on cuda)."""
    top_k = _top_k(cfg, all_item_ids, max_item_id, next(model.parameters()).device)
    max_out = cfg.model.gr_output_length + 1

    def eval_step(batch, candidates):
        seq, _, _ = seq_features_from_batch(batch, max_out)
        seq = seq._replace(past_embeddings=model.item_embeddings(seq.past_ids))
        encoded, lengths = model(seq)
        current = get_current_embeddings(lengths, encoded)  # [B, D]
        return top_k(current, candidates, seq.past_ids)

    return _eval_many(model, eval_step, steps) if steps > 1 else eval_step


def make_packed_eval_step(
    model: GenerativeRecommender, cfg: Config, all_item_ids: np.ndarray, max_item_id: int,
    steps: int = 1,
) -> Callable[[Dict[str, torch.Tensor], Candidates], Tuple[torch.Tensor, ...]]:
    """eval_step(batch, candidates) -> (ids [S_cap, k], scores [S_cap, k],
    seg_target [S_cap], seg_weight [S_cap]): the packed eval path. steps > 1:
    eval_steps(batches, candidates), each result stacked over the batches.

    Takes PackedBatchLoader(include_target=False) batches: several history
    segments per attention row, each segment's last history token one
    retrieval query (gathered at `seg_last_flat`), filtered by that segment's
    own ids alone (`seg_invalid_ids`): a packed row must not filter by its
    neighbours' histories. A padding slot (seg_weight 0) answers like any
    query; the caller drops it."""
    _check_packable(cfg)
    top_k = _top_k(cfg, all_item_ids, max_item_id, next(model.parameters()).device)

    def eval_step(batch, candidates):
        seq = packed_seq_features(batch)
        seq = seq._replace(past_embeddings=model.item_embeddings(seq.past_ids))
        encoded, _ = model(seq)  # [P, L, D]
        queries = encoded.flatten(0, 1)[batch["seg_last_flat"].long()]  # [S_cap, D]
        ids, scores = top_k(queries, candidates, batch["seg_invalid_ids"])
        return ids, scores, batch["seg_target"], batch["seg_weight"]

    return _eval_many(model, eval_step, steps) if steps > 1 else eval_step
