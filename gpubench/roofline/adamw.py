"""Fused AdamW over P float32 parameters: reads the parameter, its gradient
and both moments, writes the parameter and both moments (28 bytes each);
a dozen operations a parameter, far below the bandwidth's bound."""

from gpubench.roofline import F32, least_s


def step_s(params: int) -> float:
    return least_s(7 * F32 * params, 12 * params)
