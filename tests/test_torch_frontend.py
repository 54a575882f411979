"""The port's image front-end stages vs the JAX package's.

Stereo house frames rendered by the JAX package's StereoImageRenderer
(640x480, stroke 1.5, noise 2.0, seed 0) along wave_trajectory(400)[::3],
passed to both sides as numpy.  JAX runs as its own tests run it (CPU, x64
on, the front-end in float32); the port runs on CPU tensors.  Held:

- ``image_gradients``: magnitude within 1e-4 absolute; the level-line
  angle within 1e-5 rad where the magnitude reaches the detector's
  threshold (elsewhere no stage reads it);
- the native grower (``native.lsd_detect``, the same C++) bit for bit
  against JAX's binding on JAX's maps; the Python grower against the
  native one on the same maps: the same segments in the same order, each
  within 1e-3 px once its endpoints are put in one order (the two fits
  may return the major axis with either sign), gradient directions
  within 1e-6;
- ``LineSegmentDetector.detect`` end to end, each side on its own maps:
  the same segment count, endpoints within 1e-4 px;
- ``describe`` on the same maps and segments, after normalization, within
  1e-6, for the whole frame and for segment counts that are not powers of
  two (JAX pads to one, the port does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slslam_tpu import native as jnative
from slslam_tpu.frontend import descriptor as jdesc
from slslam_tpu.frontend import detector as jdet
from slslam_tpu.sim import house_segments, wave_trajectory
from slslam_tpu.sim.images import StereoImageRenderer
from slslam_tpu_torch import native as tnative
from slslam_tpu_torch.frontend import descriptor as tdesc
from slslam_tpu_torch.frontend import detector as tdet

torch.set_num_threads(1)

MAG_ATOL = 1e-4
ANGLE_ATOL = 1e-5
GROWER_PX = 1e-3
DETECT_PX = 1e-4
DESC_ATOL = 1e-6
FRAMES = (0, 12, 24)
DET = jdet.LineSegmentDetector()


@pytest.fixture(scope="module")
def images():
    ren = StereoImageRenderer(house_segments(), seed=0)
    poses = wave_trajectory(400)[::3][:25]
    out = {}
    for k in range(max(FRAMES) + 1):
        img_l, img_r, _ = ren.render(poses[k])
        if k in FRAMES:
            out[k] = (img_l, img_r)
    return out


def _jax_maps(img):
    return tuple(np.asarray(a) for a in
                 jdet.image_gradients(jnp.asarray(img, jnp.float32)))


def _angle_gap(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("k", FRAMES)
def test_image_gradients_match_jax(images, k, side):
    img = images[k][side]
    jm, ja = _jax_maps(img)
    tm, ta = tdet.image_gradients(torch.as_tensor(img))
    assert tm.dtype == ta.dtype == torch.float32
    tm, ta = tm.numpy(), ta.numpy()
    assert np.abs(tm - jm).max() <= MAG_ATOL
    read = jm >= DET.mag_threshold
    assert read.sum() > 1000
    assert _angle_gap(ta, ja)[read].max() <= ANGLE_ATOL


def test_image_gradients_edge_padding_and_flat_image():
    """A flat image has no gradient above rounding (the Gaussian's taps do
    not sum to 1 exactly in float32), as in JAX; a vertical step gives the
    Sobel response of the blurred step, the same on both sides, to the
    border."""
    flat = np.full((48, 64), 128.0, np.float32)
    m, _ = tdet.image_gradients(torch.as_tensor(flat))
    np.testing.assert_allclose(m.numpy(), _jax_maps(flat)[0], rtol=0,
                               atol=MAG_ATOL)
    assert float(m.max()) < 1e-4
    step = np.zeros((48, 64), np.float32)
    step[:, 30:] = 200.0
    jm, ja = _jax_maps(step)
    tm, ta = tdet.image_gradients(torch.as_tensor(step))
    np.testing.assert_allclose(tm.numpy(), jm, rtol=0, atol=MAG_ATOL)
    read = jm >= DET.mag_threshold
    assert _angle_gap(ta.numpy(), ja)[read].max() <= ANGLE_ATOL


@pytest.mark.parametrize("k", FRAMES)
def test_native_grower_matches_jax_bit_for_bit(images, k):
    jm, ja = _jax_maps(images[k][0])
    args = (DET.mag_threshold, DET.angle_tol, DET.min_length,
            DET.min_density)
    want = jnative.lsd_detect(jm, ja, *args)
    got = tnative.lsd_detect(jm, ja, *args)
    assert want is not None and got is not None
    assert len(got[0]) > 100
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _canon(segs):
    """Each segment with its endpoints in (x, then y) order."""
    s = segs.copy()
    swap = (s[:, 0] > s[:, 2]) | ((s[:, 0] == s[:, 2]) & (s[:, 1] > s[:, 3]))
    s[swap] = s[swap][:, [2, 3, 0, 1]]
    return s


def test_python_grower_matches_native(images):
    jm, ja = _jax_maps(images[12][0])
    det = tdet.LineSegmentDetector(device="cpu", grower="python")
    nat = tnative.lsd_detect(jm, ja, det.mag_threshold, det.angle_tol,
                             det.min_length, det.min_density)
    py = det._grow_regions(jm, ja)
    assert len(py[0]) == len(nat[0]) > 100
    np.testing.assert_allclose(_canon(py[0]), _canon(nat[0]), rtol=0,
                               atol=GROWER_PX)
    np.testing.assert_allclose(py[1], nat[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("k", FRAMES)
def test_detect_matches_jax(images, k, side):
    img = images[k][side]
    want = DET.detect(img)
    det = tdet.LineSegmentDetector(device="cpu")
    assert det.grower == "native"
    got, mag, ang = det.detect_with_gradients(img)
    assert mag.device.type == ang.device.type == "cpu"
    assert len(got) == len(want) >= 40
    np.testing.assert_allclose(got, want, rtol=0, atol=DETECT_PX)


def _sorted_rows(segs):
    s = _canon(segs)
    return s[np.lexsort(np.round(s, 1).T[::-1])]


def test_python_grower_detects_as_native(images):
    """Through the fusion and the merge the two growers give the same
    segments; the stroke-edge pairing visits its candidates in the order of
    their offsets, which the growers' 1e-4 px differences may reorder, so
    the rows are compared as a set."""
    img = images[0][1]
    a = tdet.LineSegmentDetector(device="cpu", grower="native").detect(img)
    b = tdet.LineSegmentDetector(device="cpu", grower="python").detect(img)
    assert len(a) == len(b) >= 40
    np.testing.assert_allclose(_sorted_rows(b), _sorted_rows(a), rtol=0,
                               atol=GROWER_PX)


def test_empty_image_detects_nothing():
    det = tdet.LineSegmentDetector(device="cpu")
    assert len(det.detect(np.full((480, 640), 128.0))) == 0


def test_grower_is_reported_and_missing_native_warns(monkeypatch):
    assert tdet.resolve_grower() == "native"
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.warns(RuntimeWarning, match="Python grower"):
        det = tdet.LineSegmentDetector(device="cpu")
    assert det.grower == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        tdet.resolve_grower("native")
    with pytest.raises(ValueError):
        tdet.resolve_grower("opencv")


def test_detector_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        tdet.LineSegmentDetector()


@pytest.mark.parametrize("count", [None, 37, 1])
@pytest.mark.parametrize("k", [0, 24])
def test_describe_matches_jax(images, k, count):
    """The whole frame's segments, and the first ``count`` of them (JAX
    pads to 32 / 64 / 128 rows, the port describes them as they are)."""
    img = images[k][0]
    jm, ja = _jax_maps(img)
    segs = DET.detect(img)
    if count is not None:
        segs = segs[:count]
    want = jdesc.describe(jm, ja, segs)
    got = tdesc.describe(torch.as_tensor(jm), torch.as_tensor(ja), segs)
    assert got.dtype == np.float32 and got.shape == (len(segs), 72)
    np.testing.assert_allclose(got, want, rtol=0, atol=DESC_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_describe_no_segments():
    m = torch.zeros(480, 640)
    out = tdesc.describe(m, m, np.zeros((0, 4)))
    assert out.shape == (0, 72) and out.dtype == np.float32
