"""The port's native (C++) BAL parser against its NumPy parser and the JAX
package's native parser, and ``load_bal``'s routing between them.

g++ builds the parser into gbp_poplar_tpu_torch/_build/ on first use.
"""

import bz2
import os

import numpy as np
import pytest

from gbp_poplar_tpu.native import balio_native as jax_native
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu_torch.native import balio_native
from gbp_poplar_tpu_torch.utils import balio
from tests.conftest import requires_sequences


def _assert_same_problem(a, b, rtol=1e-7):
    """tests/test_native.py's comparison: the sizes and indices exact, the
    values within ``rtol``."""
    assert (a.n_keyframes, a.n_points, a.n_edges) == (
        b.n_keyframes, b.n_points, b.n_edges)
    np.testing.assert_array_equal(a.cam_idx, b.cam_idx)
    np.testing.assert_array_equal(a.lmk_idx, b.lmk_idx)
    for f in ("measurements", "cam_means", "lmk_means", "k"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol,
                                   err_msg=f)


@pytest.fixture
def tiny(tmp_path):
    prob = balio.synthetic_problem(n_keyframes=4, n_points=20, seed=5)
    path = str(tmp_path / "tiny.txt")
    balio.save_bal(path, prob)
    return prob, path


@requires_sequences
def test_port_native_matches_numpy_parser_on_a_sequence():
    path = jax_balio.find_sequence("fr2robot2")
    _assert_same_problem(balio_native.load(path),
                         balio.load_bal(path, use_native=False))


def test_port_native_roundtrip_via_save(tiny):
    prob, path = tiny
    a = balio_native.load(path)
    assert os.path.dirname(balio_native.library()._name).endswith("_build")
    np.testing.assert_array_equal(a.cam_idx, prob.cam_idx)
    assert a.cam_idx.dtype == a.lmk_idx.dtype == np.uint32
    np.testing.assert_allclose(a.measurements, prob.measurements, rtol=1e-6)
    np.testing.assert_allclose(a.cam_means, prob.cam_means, rtol=1e-12)
    assert a.intrinsics is None


def test_port_native_equals_numpy_and_jax_native(tiny):
    """On the same file: the port's native parse equals its NumPy parse
    and the JAX package's native parse, array for array and to the bit."""
    _, path = tiny
    ours = balio_native.load(path)
    for other in (balio.load_bal(path, use_native=False),
                  jax_native.load(path)):
        for f in ("n_keyframes", "n_points", "n_edges"):
            assert getattr(ours, f) == getattr(other, f), f
        for f in ("k", "cam_idx", "lmk_idx", "measurements", "cam_means",
                  "lmk_means"):
            a, b = getattr(ours, f), getattr(other, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_port_native_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.txt")
    with open(path, "w") as f:
        f.write("not a bal file\n")
    with pytest.raises(ValueError):
        balio_native.load(path)


def test_port_load_bal_routes_by_format(tiny, tmp_path):
    """A plain TUM-variant file goes native; a Snavely file, a .bz2 file
    and a file the strict parse refuses go down the NumPy path, with the
    same result as ``use_native=False``."""
    prob, path = tiny
    n = balio_native.load.calls
    got = balio.load_bal(path)
    assert balio_native.load.calls == n + 1
    _assert_same_problem(got, balio.load_bal(path, use_native=False), 0)

    snav = str(tmp_path / "snavely.txt")
    balio.save_bal(snav, balio.synthetic_problem_snavely(4, 20, seed=1))
    packed = str(tmp_path / "tiny.txt.bz2")
    with open(path, "rb") as src, bz2.open(packed, "wb") as dst:
        dst.write(src.read())
    # a TUM file with one token too many: the native parse refuses it, the
    # NumPy parse raises on the token count
    extra = str(tmp_path / "extra.txt")
    with open(path) as src, open(extra, "w") as dst:
        dst.write(src.read() + "1.0\n")
    n = balio_native.load.calls
    assert balio._sniff_is_snavely(snav) and not balio._sniff_is_snavely(path)
    s = balio.load_bal(snav)
    assert s.intrinsics is not None and s.n_keyframes == 4
    _assert_same_problem(balio.load_bal(packed), prob, 1e-6)
    with pytest.raises(ValueError, match="matches neither"):
        balio.load_bal(extra)
    assert balio_native.load.calls == n
