"""The data and weight makers: shapes, label skew, seeds."""
import json
from pathlib import Path

import pytest
import torch

from portbench import inputs

HERE = Path(__file__).resolve().parent


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_mnist_shapes_and_label_skew():
    cfg = config("wpfed-mnist-cnn")
    d = inputs.make_data(cfg, 8, 2 ** 31 + 7, "cpu")
    assert d["x_train"].shape == (8, 280, 28, 28, 1)
    assert d["x_ref"].shape == (8, 64, 28, 28, 1)
    assert d["y_train"].dtype == torch.int32
    for i in range(8):
        seen = set(d["y_train"][i].tolist())
        assert 3 <= len(seen) <= 5         # 5 classes, one missing a shard
        shift = 5 * (i % 2)
        raw = {(y - shift) % 10 for y in seen}
        assert len(raw) == len(seen)
    # the two clusters map the same raw class to labels 5 apart
    assert set(d["y_ref"][0].tolist()) <= set(range(10))


def test_timeseries_shapes_and_cohorts():
    cfg = config("wpfed-aecg-tcn")
    d = inputs.make_data(cfg, 6, 11, "cpu")
    assert d["x_train"].shape == (6, 201, 60, 1)
    assert d["x_ref"].shape == (6, 48, 60, 1)
    assert set(d["y_train"].unique().tolist()) == {0, 1}
    # windows of 80 % of the length, zero-padded at the end
    assert float(d["x_train"][:, :, 48:, 0].abs().max()) == 0.0
    assert float(d["x_train"][:, :, :48, 0].abs().amax(-1).min()) > 0.0


@pytest.mark.parametrize("name,count", [("wpfed-mnist-cnn", 421_642),
                                        ("wpfed-aecg-tcn", 10_594)])
def test_weights_follow_the_seed(name, count):
    model = config(name)["model"]
    assert inputs.param_count(model) == model["parameters"] == count
    a = inputs.make_weights(model, 3, 5, "cpu")
    b = inputs.make_weights(model, 3, 5, "cpu")
    c = inputs.make_weights(model, 3, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    for k, v in a.items():
        if v.ndim == 2:
            assert float(v.abs().max()) == 0.0        # biases start at 0


def test_data_follows_the_seed():
    cfg = config("wpfed-aecg-tcn")
    a = inputs.make_data(cfg, 4, 3, "cpu")
    b = inputs.make_data(cfg, 4, 3, "cpu")
    c = inputs.make_data(cfg, 4, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x_train"], c["x_train"])
