"""The control comes out not correct, at a size a test run holds: the
plain reference in the nearest precision below the configuration's,
put in the program's place (the sharded draw with int16 codes of 15
fraction bits for the int32 table's 24; the DQN step with every matrix
product's operands in TF32 for float32)."""
import torch
import pytest
from perfbench_testkit import CELLS, catalog, small  # noqa: F401

from perfbench.harness.window import run_window


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (5, 2 ** 31 + 3))
def test_control_fails(catalog, small, cell, seed):
    config, traffic = small[cell]
    cpu = torch.device("cpu")
    drv = catalog.driver(traffic["driver"]).Driver(config, traffic, seed,
                                                   cpu, 0.2)
    drv.setup()
    run_window(drv, cpu, 0.2, False)
    drv.finish()
    drv.release()
    limits = traffic["limits"]
    assert all(v <= limits[k] for k, v in drv.check().items())
    control = drv.check("control")
    assert any(v > limits[k] for k, v in control.items()), control
