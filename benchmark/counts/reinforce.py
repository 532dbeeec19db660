"""The REINFORCE reduction's lse pass (``lse_split_kernel`` +
``lse_pass_kernel``, K4+K5) and reward pass (``reward_pass_kernel``, K6):
each runs the m×n descriptor product of every pair as three TF32
products (3xTF32) on the tensor cores."""


def product_ops(B: int, m: int, n: int, D: int) -> float:
    return 2.0 * B * m * n * D


def pass_ops(B: int, m: int, n: int, D: int) -> float:
    return 3 * product_ops(B, m, n, D)
