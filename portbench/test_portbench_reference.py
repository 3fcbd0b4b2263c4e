"""The reference against the port's plain versions: 8 clients, 2 rounds,
the whole run flow on the CPU (the harness's look for a card skipped)."""
import functools
import json
from pathlib import Path

import pytest
import torch
from torch.func import vmap

from portbench import cells, check, harness, inputs
from portbench.reference import models

HERE = Path(__file__).resolve().parent
# The cells' limits are set from readings on the card at the cells' sizes.
# At 8 clients on the CPU's convolutions the sound runs read gaps of at
# most 1.8e-7 (loss), 2.9e-7 (targets), 0 (l_ij), 6.6e-6 (update),
# 2.4e-6 (moment), 3.1e-5 (parameters), the TF32 control 8.3e-6, 5.6e-5,
# 1.8e-6, 8.9e-5, 6.4e-5 and 1.2e-2 (aecg, 8 clients; mnist's parameters
# 7.5e-6 and 6.2e-2): the CPU runs are held to limits between.
CPU_LIMITS = {"loss_gap": 2e-6, "ref_loss_gap": 2e-5, "nbr_loss_gap": 3e-6,
              "update_gap": 3e-5, "moment_gap": 2e-5, "param_gap": 5e-4}


def cpu_run(cell_name, *, tf32=False, wrap=None, traffic=None):
    cell = cells.load_cell(cell_name)
    cell["cell_data"] = {**cell["cell_data"], "limits": CPU_LIMITS}
    opts = harness.Options(device="cpu", tf32=tf32, wrap_program=wrap,
                           traffic={"clients": 8, "check_rounds": 2,
                                    **(traffic or {})})
    return harness.execute(cell, 2 ** 31 + 101, 0.0, False, opts,
                           log=lambda s: None)


@pytest.mark.parametrize("name", ["wpfed-mnist-cnn", "wpfed-aecg-tcn"])
def test_reference_models_equal_the_ports(name):
    from repro_torch.configs.paper_models import ClientModelConfig
    from repro_torch.models.client import apply_client_model, client_template
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    model = cfg["model"]
    mcfg = ClientModelConfig(model["name"], model["kind"],
                             tuple(model["input_shape"]),
                             model["num_classes"], tuple(model["hidden"]),
                             model["kernel_size"])
    w = inputs.make_weights(model, 3, 9, "cpu")
    x = inputs.make_data(cfg, 3, 9, "cpu")["x_ref"]
    port = vmap(functools.partial(apply_client_model,
                                  client_template(mcfg)))(w, x)
    mine = models.forward(model["kind"], w, x)
    torch.testing.assert_close(mine, port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell,traffic", [
    ("mnist-personal-1k", None),                         # exact selection
    ("aecg-personal-4k", {"backend": "ann"}),            # the ANN route
    ("mnist-personal-1k", {"schedule": "gossip",         # a gossip period
                           "reselect_every": 2}),        # in the window
])
def test_reference_holds_the_plain_versions(cell, traffic):
    res = cpu_run(cell, traffic=traffic)
    checks = res["checks"]
    assert res["correct"], checks
    for name in check.EXACT:
        assert checks[name][0] == 0, (name, checks)
    assert res["attempted"] >= 1
