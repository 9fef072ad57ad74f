"""SASRec in the PyTorch port against the JAX package, on the CPU.

The forward, loss and every gradient (one and two heads) and three AdamW
steps on synthetic-smoke's data with `encoder.kind=sasrec` and the JAX
weights carried across (tests/torch_port_families.py); the attention's
dropout as flax draws it (one [N, N] keep mask a block, shared by every row
and head); `/v1/retrieve` through the CPU engine against the JAX engine;
generation's raise; the optimizer labels of SASRec's parameters against
JAX's; Muon over SASRec's 3-D kernels raises;
and the ml-1m-hstu-aux, ml-1m-sasrec and in-batch recipes through
`cli.train`, `cli.eval` and `cli.predict` from files and from the synthetic
draw, cut to D=16, histories of 32, batches of 16 and one epoch.

Tolerances: tests/test_torch_port_train_step.py's (the loss at rtol 1e-5,
every gradient at rtol 2e-4 / atol 2e-6, the parameters after three steps
at atol 2e-5); top-k by `topk_agree` at atol 1e-5
(tests/test_torch_port_serving.py's).
"""

import copy
import csv
import json

import jax
import numpy as np
import pytest
import torch

from mygenerativerecommenders_tpu.serving.service import ServingEngine as JaxEngine
from mygenerativerecommenders_tpu_torch.cli import eval as cli_eval
from mygenerativerecommenders_tpu_torch.cli import predict as cli_predict
from mygenerativerecommenders_tpu_torch.cli import train as cli_train
from mygenerativerecommenders_tpu_torch.models.decode import check_decodable
from mygenerativerecommenders_tpu_torch.models.sasrec import MultiHeadAttention
from mygenerativerecommenders_tpu_torch.ops.topk import topk_agree
from mygenerativerecommenders_tpu_torch.serving.service import ServingEngine
from mygenerativerecommenders_tpu_torch.train.optimizers import build_optimizer
from tests import torch_port_families as fam
from tests.torch_port_families import one_torch_thread  # noqa: F401  (a fixture)
from tests.torch_port_real_files import write_ml1m_zip

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


@pytest.mark.parametrize("where", ["optimizer1", "optimizer2"])
def test_muon_over_a_sasrec_encoder_raises_naming_the_roadmap_item(where):
    s = fam.shared(overrides=SASREC, heads=2)
    opt1, opt2 = copy.deepcopy(s.pcfg.optimizer1), copy.deepcopy(s.pcfg.optimizer2)
    if where == "optimizer1":
        opt1.kind = "muon"
    else:
        opt2.enabled, opt2.kind = True, "muon"
    with pytest.raises(NotImplementedError, match="Other model families"):
        build_optimizer(opt1, opt2, s.pmodel.named_parameters(), 1e-3)


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
