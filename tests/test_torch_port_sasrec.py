"""SASRec in the PyTorch port against the JAX package, on the CPU.

The forward, loss and every gradient (one and two heads) and three AdamW
steps on synthetic-smoke's data with `encoder.kind=sasrec` and the JAX
weights carried across (tests/torch_port_families.py); the attention's
dropout as flax draws it (one [N, N] keep mask a block, shared by every row
and head); `/v1/retrieve` through the CPU engine against the JAX engine;
generation's raise; the optimizer labels of SASRec's parameters against
JAX's; three two-optimizer steps (AdamW, and Muon or spectral Scion on the
encoder's 3-D kernels and 2-D biases, flattened to [shape[0], rest] as JAX
flattens them) against JAX's after each step, and Scion's orthogonal
re-init of the 3-D kernels; and the ml-1m-hstu-aux, ml-1m-sasrec and in-batch recipes through
`cli.train`, `cli.eval` and `cli.predict` from files and from the synthetic
draw, cut to D=16, histories of 32, batches of 16 and one epoch.

Tolerances: tests/test_torch_port_train_step.py's (the loss at rtol 1e-5,
every gradient at rtol 2e-4 / atol 2e-6, the parameters after three steps
at atol 2e-5); top-k by `topk_agree` at atol 1e-5
(tests/test_torch_port_serving.py's). With Muon or Scion as
tests/test_torch_port_optimizers.py holds them: NS-5 replaced on both sides
by the same float32 iteration, every parameter at atol 2e-5 and the losses
at rtol 1e-4 after each step; with the real bfloat16 NS-5, each matrix's
movement within 0.15 of JAX's in relative Frobenius norm (NS-5's own band
at five iterations; measured up to 0.121 over SASRec's 16 matrices), the
other parameters at atol 1e-4 (BF16_ATOL; measured up to 3.6e-5) and the
losses at rtol 5e-4 (the 16 matrices' differences move the next loss by up
to 1.25e-4, measured); the orthogonal init's singular values at rtol 1e-5.
"""

import copy
import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.configs import OptimizerConfig as JaxOptimizerConfig
from mygenerativerecommenders_tpu.train import optimizers as jax_opt
from mygenerativerecommenders_tpu.train import task_retrieval as jax_task
from mygenerativerecommenders_tpu.serving.service import ServingEngine as JaxEngine
from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
from mygenerativerecommenders_tpu_torch.cli import predict as cli_predict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.models.decode import check_decodable
from mygenerativerecommenders_tpu_torch.models.sasrec import MultiHeadAttention
from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.checkpoint import params_to_state_dict
from mygenerativerecommenders_tpu_torch.configs import OptimizerConfig
from mygenerativerecommenders_tpu_torch.train import optimizers as pt_opt
from mygenerativerecommenders_tpu_torch.train import task_retrieval as pt_task
from tests import torch_port_families as fam
from tests.test_torch_port_optimizers import ns_f32  # noqa: F401  (a fixture)
from tests.torch_port_threads import one_torch_thread  # noqa: F401  (a fixture)
from tests.torch_port_real_files import write_ml1m_zip

# every test's torch ops on one thread (tests/torch_port_threads.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SASREC = (("model.encoder.kind", "sasrec"),)


# the key projection's bias adds q . b_k to every logit of a query row, which
# the softmax cancels: its exact gradient is zero, float32 noise on both sides
KEY_BIASES = [f"sequence_encoder._sasrec.mha_{i}.key.bias" for i in range(2)]


@pytest.mark.parametrize("heads", [1, 2])
def test_sasrec_forward_loss_and_every_gradient_match_jax(heads):
    s = fam.shared(overrides=SASREC, heads=heads)
    fam.compare_loss_and_grads(s, s.batches[0], jax.random.fold_in(jax.random.PRNGKey(7), 0),
                               expect="loss_fn_dense")
    named = dict(s.pmodel.named_parameters())
    for name in KEY_BIASES:
        assert float(named[name].grad.abs().max()) < 1e-6, name


def test_three_adamw_steps_of_sasrec_match_jax():
    """Every parameter but the key biases, whose zero gradient Adam turns
    into steps of lr along the sign of float32 noise (held to zero above)."""
    fam.compare_three_adamw_steps(fam.setup(overrides=SASREC, heads=2),
                                  undetermined=KEY_BIASES)


def test_attention_dropout_keeps_one_mask_for_every_row_and_head():
    """flax's `broadcast_dropout=True`: one [N, N] keep mask, scaled by
    1 / keep, multiplies the softmax weights of every row and head."""
    b, n, d, h, rate = 3, 7, 8, 2, 0.5
    g = torch.Generator().manual_seed(0)
    mha = MultiHeadAttention(d, h, rate, g).train()
    x = torch.randn(b, n, d, generator=g)
    q_in = torch.randn(b, n, d, generator=g)
    torch.manual_seed(5)
    got = mha(q_in, x)
    torch.manual_seed(5)
    keep = torch.empty(n, n).bernoulli_(1 - rate) / (1 - rate)
    q = mha.query(q_in) / (d // h) ** 0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, mha.key(x))
    logits = logits.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -torch.inf)
    want = mha.out(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1) * keep,
                                mha.value(x)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got, mha.eval()(q_in, x))


def test_sasrec_retrieve_through_the_cpu_engine_equals_jax_and_generation_raises():
    s = fam.shared(overrides=SASREC, heads=2)
    max_id = int(s.item_ids.max())
    seqs = [[int(i) for i in s.item_ids[j: j + 3 + 9 * j]] for j in range(4)]
    want = JaxEngine(s.jmodel, s.params, s.jcfg, s.item_ids, max_id, batch_size=4)
    got = ServingEngine(s.pmodel, s.pcfg, s.item_ids, max_id, batch_size=4, device="cpu")
    want_ids, want_scores = want.retrieve(seqs)
    got_ids, got_scores = got.retrieve(seqs)
    assert topk_agree(got_ids, got_scores, want_ids, want_scores, 1e-5) is None
    with pytest.raises(ValueError, match="model.encoder.kind='hstu'"):
        check_decodable(s.pcfg.model)
    with pytest.raises(ValueError, match="model.encoder.kind"):
        got.generate(seqs, steps=2, mode="greedy")


def test_param_labels_of_sasrec_equal_jax():
    """JAX labels each leaf "primary" (optimizer1) or "matrix" (optimizer2)
    by its path and rank; the port's names and shapes give the same labels
    (the attention's 3-D kernels and 2-D biases "matrix")."""
    got = fam.check_param_labels(fam.shared(overrides=SASREC, heads=2))
    assert got["sequence_encoder._sasrec.mha_0.query.kernel"] == "matrix"
    assert got["sequence_encoder._sasrec.ffn_1.conv2.bias"] == "primary"


# bfloat16 NS-5 on both sides: NS-5's relative Frobenius band at five
# iterations and tests/test_torch_port_optimizers.py's atol for the rest
BF16_FROBENIUS_BAND, BF16_ATOL, BF16_LOSS_RTOL = 0.15, 1e-4, 5e-4
MATRIX_OPTIMIZERS = {
    "muon": dict(kind="muon", lr=5e-3, momentum=0.95, nesterov=True, weight_decay=0.0),
    "scion": dict(kind="scion", lr=1e-3, momentum=0.1, norm="spectral", unconstrained=True),
}


@pytest.mark.parametrize("ns", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(MATRIX_OPTIMIZERS))
def test_muon_and_scion_over_a_sasrec_encoder_match_jax_after_each_step(kind, ns, request):
    """AdamW on the primary parameters and Muon or spectral Scion on the
    encoder's 3-D attention kernels and 2-D biases, three steps on the JAX
    step's own negatives. The key biases' exact gradient is zero (held
    above): NS-5 turns each side's float32 noise there into an orthogonal
    update of its own, so they are left out."""
    if ns == "float32":
        request.getfixturevalue("ns_f32")
    s = fam.setup(overrides=SASREC, heads=2)
    opt2 = MATRIX_OPTIMIZERS[kind]
    adamw = dict(kind="adamw", lr=5e-4, weight_decay=1e-3)
    s.jcfg.optimizer1, s.jcfg.optimizer2 = JaxOptimizerConfig(**adamw), JaxOptimizerConfig(**opt2)
    s.pcfg.optimizer1, s.pcfg.optimizer2 = OptimizerConfig(**adamw), OptimizerConfig(**opt2)
    rng, lr1, lr2 = jax.random.PRNGKey(11), adamw["lr"], opt2["lr"]
    jstep = jax_task.make_train_step(s.jmodel, s.jcfg, s.item_ids)
    jstate = jax_opt.build_optimizer(s.jcfg.optimizer1, s.jcfg.optimizer2, s.params, lr1,
                                     lr2).init(s.params)
    optimizer = pt_opt.build_optimizer(s.pcfg.optimizer1, s.pcfg.optimizer2,
                                       s.pmodel.named_parameters(), lr1, lr2)
    labels = pt_opt.param_labels(s.pmodel.named_parameters())
    deep = [n for n, p in s.pmodel.named_parameters() if p.ndim > 2]
    assert deep and all(labels[n] == "matrix" for n in deep)
    assert {id(p) for g in optimizer.matrix.param_groups for p in g["params"]} == {
        id(p) for n, p in s.pmodel.named_parameters() if labels[n] == "matrix"}
    pstep = pt_task.make_train_step(s.pmodel, s.pcfg, s.item_ids, optimizer)
    before = {k: v.clone() for k, v in s.pmodel.state_dict().items()}
    jparams = s.params
    for step in range(3):
        batch = s.batches[step % len(s.batches)]
        out = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                    rng, lr1, lr2, step)
        jparams, jstate = out.params, out.opt_state
        drawn = fam.jax_draw(jax.random.fold_in(rng, step), fam.draw_shape(s.pcfg, batch),
                             False, len(s.item_ids))
        loss = pstep(fam.torch_batch(batch), lr1, lr2, neg_offsets=drawn)
        np.testing.assert_allclose(loss.item(), float(out.loss),
                                   rtol=1e-4 if ns == "float32" else BF16_LOSS_RTOL)
        want = params_to_state_dict(fam.np_tree(jparams))
        for name, p in s.pmodel.named_parameters():
            if name in KEY_BIASES:
                continue
            got, start = p.detach().numpy(), before[name].numpy()
            if labels[name] == "matrix":
                assert np.abs(got - start).max() > 1e-6, (name, step)  # the optimizer moved it
            if ns == "float32":
                np.testing.assert_allclose(got, want[name].numpy(), rtol=0, atol=fam.STEP_ATOL,
                                           err_msg=f"{name}, step {step}")
            elif labels[name] == "matrix":
                moved, want_moved = got - start, want[name].numpy() - start
                rel = np.linalg.norm(moved - want_moved) / np.linalg.norm(want_moved)
                assert rel < BF16_FROBENIUS_BAND, (name, step, rel)
            else:
                np.testing.assert_allclose(got, want[name].numpy(), rtol=0, atol=BF16_ATOL,
                                           err_msg=f"{name}, step {step}")


def test_scion_init_of_the_3d_attention_kernels_is_orthogonal_as_in_jax():
    """Each 3-D kernel, flattened to [shape[0], rest], gets an orthogonal
    init times (d_out / d_in)^0.5 * scale: all singular values that scale,
    as JAX's `scion_init_params` gives; the primary parameters stay."""
    s = fam.shared(overrides=SASREC, heads=2)
    pmodel = copy.deepcopy(s.pmodel)
    scale = 0.5
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    pt_opt.scion_init_params(pmodel.named_parameters(), OptimizerConfig(kind="scion", scale=scale),
                             torch.Generator().manual_seed(0))
    params = fam.np_tree(s.params["params"])
    want = params_to_state_dict(fam.np_tree(jax_opt.scion_init_params(
        jax.random.PRNGKey(0), params, jax_opt.param_labels(params),
        JaxOptimizerConfig(kind="scion", scale=scale))))
    labels = pt_opt.param_labels(pmodel.named_parameters())
    deep = 0
    for name, p in pmodel.named_parameters():
        if labels[name] == "primary":
            assert torch.equal(p.detach(), before[name]), name
            continue
        if p.ndim < 2:
            continue
        deep += p.ndim > 2
        flat = p.detach().reshape(p.shape[0], -1).numpy()
        d_out, d_in = flat.shape
        got_s = np.linalg.svd(flat, compute_uv=False)
        want_s = np.linalg.svd(want[name].reshape(d_out, -1).numpy(), compute_uv=False)
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(got_s, (d_out / d_in) ** 0.5 * scale, rtol=1e-5, err_msg=name)
    assert deep == 8  # query, key, value, out of two blocks


@pytest.mark.parametrize("preset,extra,source", [
    ("ml-1m-hstu-aux", [], "files"),
    ("ml-1m-sasrec", [], "files"),
    ("ml-1m-hstu", ["model.sampler.kind=in_batch"], "files"),
    ("ml-1m-hstu-aux", [], "synthetic"),
    ("ml-1m-sasrec", [], "synthetic"),
    ("ml-1m-hstu", ["model.sampler.kind=in_batch"], "synthetic"),
])
def test_recipes_train_evaluate_and_predict_through_the_clis(tmp_path, preset, extra, source,
                                                            one_torch_thread):
    if source == "files":
        write_ml1m_zip(tmp_path)
        data = [f"data.data_dir={tmp_path}"]
    else:
        data = ["data.dataset_name=synthetic", "data.synthetic_num_users=48"]
    args = [f"experiment={preset}", *data, *extra, "trainer.device=cpu",
            "model.item_embedding_dim=16", "data.max_sequence_length=32",
            "data.batch_size=16", "model.loss.num_to_sample=16", "trainer.max_epochs=1",
            "trainer.min_epochs=1", "trainer.log_every_n_steps=1",
            f"trainer.output_dir={tmp_path / 'out'}"]
    cli_train.main(args)
    run = tmp_path / "out" / preset
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert losses and np.isfinite(losses).all()
    best = run / "checkpoints" / "best.pt"
    assert best.exists() and (run / "checkpoints" / "last.pt").exists()
    with_best = args + [f"trainer.ckpt_path={best}"]
    metrics = cli_eval.main(with_best)
    assert np.isfinite(list(metrics.values())).all()
    with open(cli_predict.main(with_best), newline="") as f:
        predicted = list(csv.DictReader(f))
    assert predicted and all(len(json.loads(r["top_k_ids"])) > 0 for r in predicted)
    if "aux" in preset:  # the user columns ride along in the sequence table
        assert "zip_code" in predicted[0]
