"""The port's metric tables (``latentfusion_tpu_torch/pose/format.py``) give
the JAX package's strings character for character, and
``concat_camera_metrics`` its lists."""
import math

import numpy as np
import pytest

from latentfusion_tpu.pose import format as jformat
from latentfusion_tpu.pose import metrics as jmetrics

from latentfusion_tpu_torch.pose import format as tformat
from latentfusion_tpu_torch.pose import metrics as tmetrics


def _metrics(rng, n):
    return [{"rotation_dist": float(rng.uniform(0, math.pi)),
             "translation_dist": float(rng.uniform(0, 0.2)),
             "add": float(rng.uniform(0, 0.15)), "add_s": float(rng.uniform(0, 0.12)),
             "add_sym": float(rng.uniform(0, 0.15)), "proj2d": float(rng.uniform(0, 40))}
            for _ in range(n)]


@pytest.mark.parametrize("name", ["", "obj_000001 mean (8 frames)"])
def test_metrics_table_matches_jax(name):
    rng = np.random.default_rng(0)
    m = _metrics(rng, 1)[0]
    out = tformat.metrics_table(m, name=name)
    assert out == jformat.metrics_table(m, name=name)
    assert "rotation_dist (deg)" in out
    acc = {"add_0.1d": 0.75, "add_s_0.1d": 1.0}
    assert tformat.metrics_table(acc, name="accuracy") == jformat.metrics_table(
        acc, name="accuracy")


@pytest.mark.parametrize("names", [None, ["coarse", "fine", "a-long-stage-name"]])
def test_metrics_table_multiple_matches_jax(names):
    rng = np.random.default_rng(1)
    ms = _metrics(rng, 3)
    out = tformat.metrics_table_multiple(ms, names=names)
    assert out == jformat.metrics_table_multiple(ms, names=names)
    assert out.count("accuracy @") == 3 and "MEAN" in out
    # No point metric: no threshold rows.
    rot = [{"rotation_dist": m["rotation_dist"], "frame": 3} for m in ms]
    assert tformat.metrics_table_multiple(rot) == jformat.metrics_table_multiple(rot)
    assert tformat.metrics_table_multiple(ms, thresholds=(0.01,)) == \
        jformat.metrics_table_multiple(ms, thresholds=(0.01,))


def test_simple_table_matches_jax():
    rows = [["a", 1.5, 3], ["bbbbbbbb", 0.123456, "x"]]
    assert tformat.simple_table(rows, ["h1", "h2", "h3"]) == jformat.simple_table(
        rows, ["h1", "h2", "h3"])


def test_concat_camera_metrics_matches_jax():
    ms = _metrics(np.random.default_rng(2), 4)
    assert tmetrics.concat_camera_metrics(ms) == dict(jmetrics.concat_camera_metrics(ms))
