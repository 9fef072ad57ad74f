"""Offline ETL entry point: the processed sequence files of a dataset.

Port of mygenerativerecommenders_tpu/cli/prepare_data.py. Usage:

  python -m mygenerativerecommenders_tpu_torch.cli.prepare_data experiment=ml-1m-hstu \\
      data.data_dir=<dir>

reads the raw files already under `data.data_dir` (`movielens_ml-1m.zip`,
`movielens_ml-20m.zip`, `raw/ml-20mx16x32/trainx16x32_<i>.npz`,
`ratings_<Category>.csv`) and writes `processed/<dataset>/` there
(data/preprocessor.py); a missing raw file raises `FileNotFoundError` naming
it. A synthetic dataset is drawn in memory and writes nothing.
"""

from __future__ import annotations

import sys
from typing import Optional

from mygenerativerecommenders_tpu_torch.cli.train import parse_args
from mygenerativerecommenders_tpu_torch.data.dataset import RecoData
from mygenerativerecommenders_tpu_torch.train.loggers import get_logger

log = get_logger(__name__)


def main(argv: Optional[list[str]] = None) -> RecoData:
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    data = RecoData(cfg.data, seed=cfg.trainer.seed)
    out = data.processor.output_format_csv() if data.processor else "memory (synthetic)"
    log.info(
        f"prepared {cfg.data.dataset_name}: "
        f"{len(data.all_item_ids)} items (max id {data.max_item_id}) -> {out}"
    )
    return data


if __name__ == "__main__":
    main()
