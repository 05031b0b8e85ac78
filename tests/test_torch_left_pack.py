"""The left-pack's plain version (``ops.cuda_select``) against the JAX
package's Pallas left-pack (interpret mode on the CPU): the packed keys and
the per-block counts must be equal, lane order included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu.ops.pallas_select import left_pack as j_left_pack
from nnpops_tpu_torch.ops.cuda_select import left_pack, left_pack_plain


def random_keys(rows, widths, density, seed):
    """Per block a random valid mask with per-row densities drawn around
    ``density`` (some rows far over the cap) and distinct keys."""
    rng = np.random.RandomState(seed)
    blocks = []
    for w in widths:
        p = np.clip(rng.normal(density, density / 2, (rows, 1)), 0.0, 1.0)
        valid = rng.rand(rows, w) < p
        keys = rng.permutation(100000)[:rows * w].reshape(rows, w)
        blocks.append(np.where(valid, keys, -1).astype(np.int32))
    return np.concatenate(blocks, 1)


def jax_left_pack(keys, widths, caps):
    """The JAX call as ``window._compact_window_kernel`` makes it: f32 keys,
    each block padded with -1 to a multiple of 128 lanes."""
    parts, off = [], 0
    for w in widths:
        blk = keys[:, off:off + w].astype(np.float32)
        pad = -w % 128
        parts.append(np.pad(blk, ((0, 0), (0, pad)), constant_values=-1.0))
        off += w
    packed, counts = j_left_pack(jnp.asarray(np.concatenate(parts, 1)),
                                 widths, caps, interpret=True)
    return (np.asarray(packed).astype(np.int32),
            np.asarray(counts).astype(np.int32))


@pytest.mark.parametrize('widths, caps, density', [
    ((351, 216), (40, 24), 0.08),         # water(150)'s angular grid
    ((486, 297), (32, 16), 0.05),         # water(867)'s angular grid
    ((324, 297), (32, 16), 0.05),         # water(8670)'s angular grid
    ((100, 37, 64), (9, 5, 64), 0.2),     # three blocks, one cap = width
    ((40, 3, 64, 17, 128, 1, 33, 90),     # MAX_BLOCKS blocks
     (8, 2, 64, 4, 10, 1, 5, 12), 0.2),
], ids=['water150', 'water867', 'water26k', 'three-blocks', 'eight-blocks'])
def test_left_pack_plain_equals_jax(widths, caps, density):
    keys = random_keys(203, widths, density, seed=sum(widths))
    packed, counts = left_pack_plain(torch.tensor(keys), widths, caps)
    j_packed, j_counts = jax_left_pack(keys, widths, caps)
    assert packed.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), j_packed)
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    over = counts.numpy() > np.asarray(caps)
    assert over.any() and (~over).any()          # both regimes are exercised


def test_left_pack_cpu_dispatch_is_plain():
    widths, caps = (64, 32), (8, 4)
    keys = torch.tensor(random_keys(50, widths, 0.1, seed=1))
    for got, want in zip(left_pack(keys, widths, caps),
                         left_pack_plain(keys, widths, caps)):
        assert torch.equal(got, want)


def test_left_pack_rejects_bad_input():
    keys = torch.full((4, 10), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match='int32'):
        left_pack(keys.long(), (6, 4), (2, 2))
    with pytest.raises(ValueError, match=r'\[N, 11\]'):
        left_pack(keys, (6, 5), (2, 2))
    with pytest.raises(ValueError, match='align'):
        left_pack(keys, (6, 4), (2,))
