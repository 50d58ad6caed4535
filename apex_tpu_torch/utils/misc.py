"""Small math and shape helpers (counterpart of :mod:`apex_tpu.utils.misc`;
reference: apex/transformer/utils.py)."""


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Integer division asserting exact divisibility."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator
