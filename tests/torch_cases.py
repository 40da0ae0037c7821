"""Case generators shared by the port's CPU tests and its card tests
(tests/test_torch_extend.py, tests/test_torch_cuda.py).  Imports nothing
of JAX, so the card tests, which run without it, can use it."""
from test_myers import random_overlap_case


def edited_pairs(rng, B, la_max, W, err=0.1):
    """random_overlap_case pairs, edited in turn: untouched, negative d0, d0
    near la, b cut short (0..19, off the multiples of 8), a shorter than the
    band; so that a warp of kernel 4 holds very different pairs."""
    a, b, la, lb, d0 = random_overlap_case(rng, B=B, la_max=la_max, err=err)
    for p in range(B):
        kind = p % 5
        if kind == 1:
            d0[p] = -int(rng.integers(1, W + 40))
        elif kind == 2:
            d0[p] = la[p] - int(rng.integers(0, W))
        elif kind == 3:
            lb[p] = int(rng.integers(0, 20))
        elif kind == 4:
            la[p], lb[p] = int(rng.integers(1, W + 1)), int(rng.integers(0, 12))
    return a, b, la, lb, d0
