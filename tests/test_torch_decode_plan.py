"""The split-KV plan of the paged decode kernel (``decode_split_plan``): a
plain function of the page table's shape, run on the CPU."""
import inspect

import pytest

pytest.importorskip("torch")

from repro_torch.kernels.paged_attention.kernel import (  # noqa: E402
    DECODE_KEY_TILE, SM_COUNT, decode_split_plan,
)

# (B, Hkv, N, page, D): the serve shapes (llama3-8b at ctx 528 and the
# checks' 2048), the GPU test cases' pools, one sequence, odd pages
SHAPES = [(8, 8, 40, 16, 128), (8, 8, 192, 16, 128), (2, 2, 4, 8, 32),
          (3, 8, 6, 16, 64), (2, 1, 4, 8, 32), (1, 4, 2, 4, 128),
          (3, 2, 12, 16, 120), (1, 8, 40, 16, 128), (64, 8, 40, 16, 128),
          (8, 8, 40, 5, 128), (8, 8, 3, 64, 256), (4, 2, 100, 1, 8)]


def test_plan_reads_only_the_table_shape():
    """Its inputs are (B, Hkv, N, page, D) and nothing else: no context
    length and no pool size, so the small-pool and ample-pool runs of one
    trace launch the same grid."""
    assert list(inspect.signature(decode_split_plan).parameters) == [
        "b", "hkv", "n", "page", "d"]
    assert all(decode_split_plan(*s) == decode_split_plan(*s) for s in SHAPES)


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_key_slot_once(shape):
    b, hkv, n, page, d = shape
    splits, per = decode_split_plan(b, hkv, n, page, d)
    keys = n * page
    assert splits >= 1 and per > 0
    assert per % DECODE_KEY_TILE == 0 and per % page == 0
    # the runs [s * per, (s + 1) * per) tile [0, keys): none is empty
    assert (splits - 1) * per < keys <= splits * per
    covered = [0] * keys
    for s in range(splits):
        for k in range(s * per, min((s + 1) * per, keys)):
            covered[k] += 1
    assert covered == [1] * keys


def test_plan_fills_the_card_at_the_serve_shape():
    """B = 8, Hkv = 8, N = 40 (llama3-8b decode at ctx <= 640): at least
    two blocks per SM, against 64 blocks for one block per (sequence, KV
    head)."""
    splits, per = decode_split_plan(8, 8, 40, 16, 128)
    assert splits * 8 * 8 >= 2 * SM_COUNT == 264
    assert (splits, per) == (5, 128)


def test_plan_bounds_the_keys_of_a_split():
    """A wide table takes more, shorter splits than the card needs, so the
    work of a long context spreads over them (ctx 2048: 8 of 12 busy)."""
    assert decode_split_plan(8, 8, 192, 16, 128) == (12, 256)
    assert decode_split_plan(1, 8, 40, 16, 128) == (20, 32)
    assert decode_split_plan(8, 8, 0, 16, 128)[0] == 1
