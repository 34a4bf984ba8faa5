"""glomap_tpu_torch's sequential loop capture against the JAX package's
generator (glomap_tpu/utils/synthetic.py, synthesize_sequential_dataset),
array for array.

Both generators are numpy on default_rng(seed) with the same calls in the
same order, so every integer array must be equal and every float array
equal within 1e-12 (the port's rotations and two-view geometry run
through its own math on CPU f64 tensors, the JAX package's through numpy).
Two seeds at 60 frames and 3,000 points, one with 2D noise and outlier
matches; the option classes must match field for field.
"""

import dataclasses

import numpy as np
import pytest

from glomap_tpu.utils import synthetic as jsyn

from glomap_tpu_torch.utils import synthetic as tsyn

CASES = {
    "seed5_noisy": dict(num_frames=60, num_points3D=3000,
                        max_kp_per_image=500, point2D_stddev=0.5,
                        inlier_match_ratio=0.9, seed=5),
    "seed11_clean": dict(num_frames=60, num_points3D=3000, seed=11),
}


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=what)
    else:
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_options_match_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tsyn.SequentialCaptureOptions) == \
        fields(jsyn.SequentialCaptureOptions)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequential_capture_matches_jax(case):
    kw = CASES[case]
    j_scene, j_vg, j_gt = jsyn.synthesize_sequential_dataset(
        jsyn.SequentialCaptureOptions(**kw))
    scene, vg, gt = tsyn.synthesize_sequential_dataset(
        tsyn.SequentialCaptureOptions(**kw))
    assert vg.num_pairs > 100 and vg.num_matches > 10_000
    for f in dataclasses.fields(j_scene):
        a, b = getattr(scene, f.name), getattr(j_scene, f.name)
        if isinstance(b, list):
            assert a == b, f.name
        else:
            _assert_same(a, b, f"scene.{f.name}")
    for f in dataclasses.fields(j_vg):
        _assert_same(getattr(vg, f.name), getattr(j_vg, f.name),
                     f"view_graph.{f.name}")
    assert gt.keys() == j_gt.keys()
    for k in gt:
        _assert_same(gt[k], j_gt[k], f"gt[{k}]")
