"""The port stands alone: it imports neither JAX nor the JAX package (so
that it and chip_smoke.py run where only torch is installed), its skeleton
tables equal the JAX package's, and its YAML reader gives the JAX loader's
values for every key the port reads."""

import os
import re
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
        "import mhentropy_tpu_torch.run, mhentropy_tpu_torch.train.engine\n"
        "import mhentropy_tpu_torch.train.metrics, mhentropy_tpu_torch.models.quant\n"
        "import mhentropy_tpu_torch.flows.cuda_sampler_int8, mhentropy_tpu_torch.core.lbs_cuda\n"
        "import mhentropy_tpu_torch.data.synthetic, mhentropy_tpu_torch.profile_serve\n"
        "import mhentropy_tpu_torch.models.bn_cuda, mhentropy_tpu_torch.flows.cuda_sampler\n"
        "import mhentropy_tpu_torch.models.resnet, mhentropy_tpu_torch.models.encoder\n"
        "import mhentropy_tpu_torch.flows.glow, mhentropy_tpu_torch.flows.cuda_glow_sampler\n"
        "import mhentropy_tpu_torch.core.smpl, mhentropy_tpu_torch.models.prohmr\n"
        "import mhentropy_tpu_torch.eval_prohmr, mhentropy_tpu_torch.bench_prohmr\n"
        "import mhentropy_tpu_torch.models.stem_int8_cuda, mhentropy_tpu_torch.bench_quant\n"
        "import mhentropy_tpu_torch.models.stage2_int8_cuda, mhentropy_tpu_torch.int8_gemm_probe\n"
        "import mhentropy_tpu_torch.utils.logging, mhentropy_tpu_torch.models.rle\n"
        "import mhentropy_tpu_torch.data.common, mhentropy_tpu_torch.data.transforms\n"
        "import mhentropy_tpu_torch.data.occlusion, mhentropy_tpu_torch.data.colorjitter\n"
        "import mhentropy_tpu_torch.data.cached, mhentropy_tpu_torch.data.rhd\n"
        "import mhentropy_tpu_torch.data.freihand, mhentropy_tpu_torch.data.ho3d\n"
        "import mhentropy_tpu_torch.data.mixed, mhentropy_tpu_torch.core.camera\n"
        "import mhentropy_tpu_torch.core.rotations, mhentropy_tpu_torch.data.fixtures\n"
        "import mhentropy_tpu_torch.train_synthetic_demo, mhentropy_tpu_torch.export\n"
        "import mhentropy_tpu_torch.core.render, mhentropy_tpu_torch.utils.viz\n"
        "import mhentropy_tpu_torch.data.sk, mhentropy_tpu_torch.data.pose_pipeline\n"
        "import mhentropy_tpu_torch.bench_input_pipeline\n"
        "import mhentropy_tpu_torch.parallel.mesh, mhentropy_tpu_torch.parallel.sharded\n"
        "import mhentropy_tpu_torch.parallel.multihost, mhentropy_tpu_torch.parallel.pipeline\n"
        "import mhentropy_tpu_torch.utils.profiling\n"
        "import mhentropy_tpu_torch.eval_released_checkpoint, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mhentropy_tpu', 'tools'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["profile_step", "stem_probe", "stem_cost_attrib",
                                    "stage1_probe", "bench", "kernel_variants",
                                    "bench_input_pipeline"])
def test_probe_and_bench_modules_stand_alone(module):
    """Each of the probes, the bench and profile_step alone, in a fresh
    interpreter, pulls in neither JAX, the JAX package nor tools/."""
    code = (f"import sys\nimport mhentropy_tpu_torch.{module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mhentropy_tpu', 'tools'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=300)
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
    """Every key of the schema; model_dir's default is random per load in
    both packages (and pretrain_model / final_model under it), so a default
    one is compared by its pattern."""
    out = {key: {k: getattr(getattr(cfg, key), k) for k in keys} if isinstance(keys, dict)
           else getattr(cfg, key) for key, keys in config.DEFAULTS.items()}
    for key in ("model_dir", "pretrain_model", "final_model"):
        out[key] = re.sub(r"^\./model/[A-Za-z0-9]{6}/", "./model/<random>/", out[key])
    return out


def test_config_defaults_equal():
    assert _read_keys(config.make_cfg()) == _read_keys(jconfig.get_cfg_defaults())
    assert config.make_cfg().network.enc_type == jconfig.get_cfg_defaults().network.enc_type \
        == "BasicEnc"
    assert config.make_cfg({"model_dir": "/x/", "tpu": {"fused_train_bn": True}}).model_dir \
        == "/x/"


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                                        if f.endswith(".yaml")))
def test_every_shipped_yaml_loads_like_jax(name):
    path = os.path.join(REPO, "configs", name)
    assert _read_keys(config.load_cfg(path)) == _read_keys(jconfig.update_cfg(path))


def test_data_keys_read_like_jax(tmp_path):
    """The loaders' tpu keys (decode_cache, target_fields, image_u8,
    sample_cache, device_st): the JAX defaults when left out, and a YAML's
    values when set, equal to the JAX loader's."""
    keys = ("decode_cache", "target_fields", "image_u8", "sample_cache", "device_st")
    port, jax_cfg = config.make_cfg(), jconfig.get_cfg_defaults()
    assert {k: getattr(port.tpu, k) for k in keys} == {k: jax_cfg.tpu[k] for k in keys} \
        == {"decode_cache": None, "target_fields": "auto", "image_u8": True,
            "sample_cache": None, "device_st": True}
    path = tmp_path / "data.yaml"
    path.write_text("tpu: {data_dir: /d, decode_cache: /c, target_fields: full, "
                    "image_u8: false, sample_cache: /s, device_st: false}\n")
    port, jax_cfg = config.load_cfg(str(path)), jconfig.update_cfg(str(path))
    assert {k: getattr(port.tpu, k) for k in keys} == {k: jax_cfg.tpu[k] for k in keys} \
        == {"decode_cache": "/c", "target_fields": "full", "image_u8": False,
            "sample_cache": "/s", "device_st": False}
