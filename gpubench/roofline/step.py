"""A whole training step of the HSTU retrieval model (forward, backward and
AdamW), as the algorithm needs it: the dense layers over the valid tokens,
attention over the live pairs, the sampled softmax over each supervised
position's positive and R drawn negatives (not a walk of the catalog); no
recompute: attention's backward is p.g's two products and dz's two over the
live pairs, 2 (2 dqk + 2 dv) a pair and head, where the kernel's bound
(roofline/attention.py) counts the q.k it recomputes too. Bytes: every parameter, its gradient and AdamW's moments (28
bytes a parameter) and the table rows the step gathers, each once."""

from gpubench.roofline import F32, least_s


def dense_flops(tokens: int, d: int, heads: int, dqk: int, dv: int) -> float:
    """One block's projections, forward: LN(x) @ W_uvqk and the output's."""
    return 2.0 * tokens * d * 2 * heads * (dqk + dv) + 2.0 * tokens * heads * dv * d


def train_step_s(step: dict, dims, params: int) -> float:
    h, dqk, dv, d = dims.heads, dims.dqk, dims.dv, dims.d
    pairs = step["attn"]["pairs"]
    per_block = (3 * dense_flops(step["tokens"], d, h, dqk, dv)
                 + pairs * h * 2 * (dqk + dv) + pairs * h * 2 * (2 * dqk + 2 * dv))
    loss = 3 * 2.0 * step["supervised"] * d * (dims.num_negatives + 1)
    nbytes = 7 * F32 * params + F32 * d * (step["tokens"] + step["supervised"] * dims.num_negatives)
    return least_s(nbytes, dims.blocks * per_block + loss)
