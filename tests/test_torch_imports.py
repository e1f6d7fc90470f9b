"""The port stands alone: it imports neither JAX nor the JAX package (so
that it and chip_smoke.py run where only torch is installed), its skeleton
tables equal the JAX package's, and its YAML reader gives the JAX loader's
values for every key the port reads."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mhentropy_tpu.core import skeletons as jskeletons
from mhentropy_tpu.utils import config as jconfig
from mhentropy_tpu_torch.core import skeletons
from mhentropy_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """conftest imports JAX into this process, so the check runs in a fresh
    interpreter."""
    code = (
        "import sys\n"
        "import mhentropy_tpu_torch.serve, mhentropy_tpu_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mhentropy_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_skeleton_tables_equal():
    names = [n for n in dir(jskeletons) if n.isupper()]
    assert names and names == [n for n in dir(skeletons) if n.isupper()]
    for name in names:
        a, b = getattr(jskeletons, name), getattr(skeletons, name)
        if isinstance(a, dict):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(jskeletons.freihand_gather_indices(), skeletons.freihand_gather_indices()):
        np.testing.assert_array_equal(a, b)


def _read_keys(cfg):
    return {group: {k: getattr(getattr(cfg, group), k) for k in keys}
            for group, keys in config.DEFAULTS.items()}


def test_config_defaults_equal():
    assert _read_keys(config.make_cfg()) == _read_keys(jconfig.get_cfg_defaults())


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                                        if f.endswith(".yaml")))
def test_every_shipped_yaml_loads_like_jax(name):
    path = os.path.join(REPO, "configs", name)
    assert _read_keys(config.load_cfg(path)) == _read_keys(jconfig.update_cfg(path))
