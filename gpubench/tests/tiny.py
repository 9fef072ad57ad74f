"""A copy of the benchmark under a temporary root, its cells cut to a size
the CPU runs in seconds (dropout off: on the CPU the port's model
construction draws from the default generator, which the card's dropout
stream does not share, so the reference could not follow the masks here)."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CUTS = {
    "ml-20m-hstu-long": (
        {"model.encoder.num_blocks": 2, "data.max_sequence_length": 40, "data.batch_size": 4,
         "data.expected_num_unique_items": 300, "data.expected_max_item_id": 900,
         "model.item_embedding_dim": 16, "model.loss.num_to_sample": 16,
         "data.pack_capacities": "[32,64]", "model.preprocessor.dropout_rate": 0.0,
         "model.encoder.linear_dropout_rate": 0.0, "model.index.k": 20},
        dict(num_blocks=2, max_sequence_length=40, batch_size=4, num_items=300, max_item_id=900,
             item_embedding_dim=16, attention_dim=16, linear_dim=16, num_to_sample=16,
             dropout_rate=0.0, linear_dropout_rate=0.0, index_k=20)),
    "synthetic-large-vocab-local": (
        {"model.encoder.num_blocks": 2, "data.max_sequence_length": 30, "data.batch_size": 8,
         "data.expected_num_unique_items": 3000, "data.expected_max_item_id": 9000,
         "model.item_embedding_dim": 16, "model.loss.num_to_sample": 24, "model.index.k": 20,
         "model.preprocessor.dropout_rate": 0.0, "model.encoder.linear_dropout_rate": 0.0,
         # the full catalog's gate chooses the gather loss; the cut one would not
         "model.loss.dense_catalog_negatives": "false"},
        dict(num_blocks=2, max_sequence_length=30, batch_size=8, num_items=3000, max_item_id=9000,
             item_embedding_dim=16, attention_dim=16, linear_dim=16, num_to_sample=24, index_k=20,
             dropout_rate=0.0, linear_dropout_rate=0.0)),
}
MIXES = {
    "ml20m-long-train": dict(users=24, lengths={"min": 5, "max": 40}),
    "large-vocab-train": dict(users=40, lengths={"min": 5, "max": 30}),
}


def make_root(path: str) -> str:
    shutil.copytree(os.path.join(REPO, "gpubench"), os.path.join(path, "gpubench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(path, "BENCHMARK.json"))
    for name, (overrides, sizes) in CUTS.items():
        f = os.path.join(path, "gpubench", "configs", name + ".json")
        cfg = json.load(open(f))
        cfg["overrides"].update(overrides)
        cfg["sizes"].update(sizes)
        json.dump(cfg, open(f, "w"))
    for name, keys in MIXES.items():
        f = os.path.join(path, "gpubench", "traffic", name + ".json")
        mix = json.load(open(f))
        mix.update(keys)
        json.dump(mix, open(f, "w"))
    return path
