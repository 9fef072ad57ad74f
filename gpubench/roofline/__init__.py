"""The yardstick: the least time each kind of work could take on the card.

Each function counts what the algorithm needs from the shapes of the work
it is given (live pairs, live logits, touched rows), each input byte read
once and each output byte written once, and returns seconds at the peaks of
peaks.json: the larger of operations over the operation peak and bytes over
the bandwidth. The attention and lse counts are frozen copies of the port's
chip_smoke.py (`attention_work`, `attention_bound`, `attention_bwd_bound`,
:651-730, and the lse bounds, :951-964, at commit bb02319).
"""

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)

F32 = 4  # bytes of a float32 or an int32


def least_s(nbytes: float, fp32_ops: float = 0.0, int8_ops: float = 0.0) -> float:
    compute = fp32_ops / PEAKS["fp32_flops_per_s"] + int8_ops / PEAKS["int8_ops_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], compute)
