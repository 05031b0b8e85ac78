"""nnpops_tpu_torch.geometry against nnpops_tpu.geometry (rectangular and
triclinic boxes, f32 and f64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpops_tpu import geometry as jg
from nnpops_tpu_torch import geometry as tg

BOXES = {
    'rect': np.diag([9.0, 10.5, 11.25]),
    'triclinic': np.array([[10.0, 0.0, 0.0],
                           [1.5, 9.5, 0.0],
                           [-1.0, 2.0, 9.0]]),
}


def _case(name, dtype, seed=0):
    rng = np.random.RandomState(seed)
    box = BOXES[name].astype(dtype)
    delta = (rng.rand(64, 3) * 30.0 - 15.0).astype(dtype)
    pos = (rng.rand(64, 3) * 10.0).astype(dtype)
    return box, delta, pos


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('name', sorted(BOXES))
def test_geometry_matches_jax(name, dtype):
    box, delta, pos = _case(name, dtype)
    tol = dict(rtol=1e-6, atol=1e-5) if dtype == np.float32 else dict(
        rtol=1e-12, atol=1e-11)
    with jax.enable_x64(dtype == np.float64):
        jbox = jnp.asarray(box)
        want = {
            'minimum_image': jg.minimum_image(jnp.asarray(delta), jbox),
            'invert_box': jg.invert_box(jbox),
            'box_transform': jg.box_transform(jnp.asarray(pos),
                                              jg.invert_box(jbox)),
            'cosine_cutoff': jg.cosine_cutoff(jnp.abs(jnp.asarray(delta[:, 0])),
                                              5.0),
            'safe_norm': jg.safe_norm(jnp.asarray(delta)),
        }
        want = {k: np.asarray(v) for k, v in want.items()}
    tbox = torch.tensor(box)
    got = {
        'minimum_image': tg.minimum_image(torch.tensor(delta), tbox),
        'invert_box': tg.invert_box(tbox),
        'box_transform': tg.box_transform(torch.tensor(pos),
                                          tg.invert_box(tbox)),
        'cosine_cutoff': tg.cosine_cutoff(torch.tensor(delta[:, 0]).abs(), 5.0),
        'safe_norm': tg.safe_norm(torch.tensor(delta)),
    }
    for key, g in got.items():
        assert g.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype, key
        np.testing.assert_allclose(g.numpy(), want[key], err_msg=key, **tol)
    assert tg.minimum_image(torch.tensor(delta), None) is not None


def test_minimum_image_is_shortest_image():
    box, delta, _ = _case('triclinic', np.float64, seed=1)
    wrapped = tg.minimum_image(torch.tensor(delta), torch.tensor(box)).numpy()
    # Same vector modulo lattice translations; and wherever an image lies
    # within half the smallest box width (the cutoff precondition of the
    # single wrap), the wrap finds the shortest one.
    frac = (delta - wrapped) @ np.linalg.inv(box)
    np.testing.assert_allclose(frac, np.round(frac), atol=1e-9)
    offsets = np.array(np.meshgrid(*[[-1, 0, 1]] * 3)).reshape(3, -1).T @ box
    lengths = np.linalg.norm(wrapped[:, None, :] + offsets[None], axis=-1)
    near = lengths.min(1) < 0.5 * 9.0
    assert near.sum() > 10
    np.testing.assert_allclose(np.linalg.norm(wrapped, axis=-1)[near],
                               lengths.min(1)[near], rtol=1e-12)


def test_safe_norm_gradient_finite_at_zero():
    v = torch.zeros(4, 3, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tg.safe_norm(v).sum(), v)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize('box, cutoff', [
    (np.array([[10.0, 1.0, 0.0], [0.0, 10.0, 0.0], [0.0, 0.0, 10.0]]), 4.0),
    (np.diag([10.0, 10.0, 7.0]), 4.0),
    (np.array([[10.0, 0.0, 0.0], [6.0, 10.0, 0.0], [0.0, 0.0, 10.0]]), 4.0),
])
def test_validate_box_rejects_like_jax(box, cutoff):
    with pytest.raises(ValueError) as jerr:
        jg.validate_box(box, cutoff)
    with pytest.raises(ValueError) as terr:
        tg.validate_box(torch.tensor(box), cutoff)
    assert str(terr.value) == str(jerr.value)
    tg.validate_box(np.diag([10.0, 10.0, 10.0]), cutoff)
