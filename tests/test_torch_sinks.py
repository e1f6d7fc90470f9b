"""The experiment's log and scalar sinks and tpu.autoresume, against the
JAX package's (utils/logging.py, train/engine.py's Experiment), and run.py's
path on a glow MHEnt.

* ScalarWriter: the JSONL records (tag, value, step) equal JAX's for the
  same calls; get_logger: the same lines in the file and on stdout, up to
  the time stamp (tests/test_priors_logging.py:85).
* run.py on a tiny glow YAML (resnet18 at 32 px, Glow hidden 32, two
  layers): one epoch, then a rerun with tpu.autoresume and two epochs in
  the same model_dir continues at epoch 1 with the step doubled, the
  weights, Adam moments and schedule position restored
  (tests/test_experiment_integration.py:120); both runs write
  info_<mode>.log, scalars.jsonl (`loss_avg/loss_total` at each logged
  step, `metric_eval/<name>` at each eval, as JAX tags them) and the .pth
  files, and close their sinks.
"""

import gc
import json
import logging
import re

import torch

from mhentropy_tpu.utils import logging as jlogging
from mhentropy_tpu_torch import run
from mhentropy_tpu_torch.flows import glow
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.utils import logging as tlogging
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)


def _records(path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(path).read().splitlines()]


def test_scalar_writer_and_logger_match_jax(tmp_path, capsys):
    calls = [("loss_avg/loss_total", 1.5, 3), ("metric_eval/eucLoss_3d_rgb_sample", 0.25, 8),
             ("metric_eval/loss_total", -2.0, 8)]
    for mod, sub in ((tlogging, "port"), (jlogging, "jax")):
        w = mod.ScalarWriter(str(tmp_path / sub))
        for tag, value, step in calls:
            w.add_scalar(tag, value, global_step=step)
        w.close()
    assert _records(tmp_path / "port" / "scalars.jsonl") == _records(
        tmp_path / "jax" / "scalars.jsonl") == [
        {"tag": t, "value": v, "step": s} for t, v, s in calls]
    lines = {}
    for mod, sub in ((tlogging, "port"), (jlogging, "jax")):
        path = tmp_path / sub / "info.log"
        log = mod.get_logger(str(path), name=f"sinks_{sub}")
        assert not log.propagate and log.level == logging.INFO
        log.info("Epoch:0| Step:0| Avg_Loss:1.0000|")
        log.debug("dropped at verbosity 1")
        log.warning("steps_per_epoch changed")
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)
        lines[sub] = [re.sub(r"^\[[^]]*\]", "", line) for line in open(path).read().splitlines()]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 2
    assert lines["port"][0].endswith("[INFO] Epoch:0| Step:0| Avg_Loss:1.0000|")
    assert capsys.readouterr().out.count("steps_per_epoch changed") == 2


GLOW_YAML = (
    "dataset: {dataset_name: ho3d, image_size: [32, 32]}\n"
    "network: {enc_type: MHEnt, regressor: glow, num_latent: 16, backbone: resnet18,\n"
    "          glow_hidden: 32, glow_layers: 2, glow_blocks: 2}\n"
    "training: {mode: baseline_VAE, batch_size: 8, epochs: EPOCHS, test_samples: 2, seed: 1,\n"
    "           n_train_hypotheses: 2, lr: 0.001}\n"
    "info_interval: 2\n"
    "tpu: {compute_dtype: float32, autoresume: true}\n")


def test_run_trains_a_glow_mhent_and_autoresumes(tmp_path, capsys):
    model_dir = tmp_path / "run"
    path = tmp_path / "glow.yaml"
    path.write_text(GLOW_YAML.replace("EPOCHS", "1") + f"model_dir: {model_dir}/\n")
    first = run.main(["--cfg", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Epoch:0| eval_3d_rgb:" in out and "Epoch:0| Step:2| Avg_Loss:" in out
    assert "autoresume: restored" not in out and first["eucLoss_3d_rgb_sample"] > 0
    ckpt = torch.load(model_dir / "baseline_mano_0.pth")
    steps = ckpt["step"]
    assert steps == 4 and (model_dir / "baseline_final.pth").is_file()
    assert any(k.startswith("q_z_giv_i._transform._transforms.5.transform_net")
               for k in ckpt["encoderRGB"])
    recs = _records(model_dir / "scalars.jsonl")
    train = [(r["step"], r["tag"]) for r in recs if r["tag"].startswith("loss_avg")]
    assert train == [(1, "loss_avg/loss_total"), (3, "loss_avg/loss_total")]
    evals = {r["step"] for r in recs if r["tag"].startswith("metric_eval/")}
    assert evals == {0, steps} and any(r["tag"] == "metric_eval/eucLoss_3d_rgb_sample"
                                       for r in recs)
    log_path = model_dir / "info_baseline_VAE.log"
    assert "Epoch:0| Step:2| Avg_Loss:" in log_path.read_text()

    path.write_text(GLOW_YAML.replace("EPOCHS", "2") + f"model_dir: {model_dir}/\n")
    cfg = run.load_cfg(str(path))
    with engine.Experiment(cfg, device="cpu") as exp:
        assert isinstance(exp.net.q_z_giv_i, glow.ConditionalGlow)
        assert exp._latest_checkpoint() == (0, str(model_dir / "baseline_mano_0.pth"))
        train_data, _ = exp.make_datasets(which=("train",))
        exp._ensure_state(len(train_data.images) // 8)
        exp._resume(str(model_dir / "baseline_mano_0.pth"))
        assert exp.step == steps and exp.optimizer.count == steps
        for k, v in exp.net.state_dict().items():
            assert torch.equal(v.cpu(), ckpt["encoderRGB"][k]), k
        adam = exp.optimizer.adam.state_dict()
        for i, s in ckpt["optimizer"]["adam"]["state"].items():
            assert torch.equal(adam["state"][i]["exp_avg_sq"], s["exp_avg_sq"])
    assert exp.writer._jsonl.closed and not exp.log.handlers  # closed by the with block
    capsys.readouterr()
    second = run.main(["--cfg", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "autoresume: restored" in out and "continuing at epoch 1" in out
    assert "Epoch:0|" not in out and "Epoch:1| eval_3d_rgb:" in out
    assert torch.load(model_dir / "baseline_final.pth")["step"] == 2 * steps
    assert set(second) == set(first)
    train = [r["step"] for r in _records(model_dir / "scalars.jsonl")
             if r["tag"].startswith("loss_avg")]
    assert train == [1, 3, steps + 1, steps + 3]
    assert (model_dir / "info_baseline_VAE.log").read_text().count("autoresume: restored") == 1


def test_experiment_close_releases_its_sinks(tmp_path):
    path = tmp_path / "glow.yaml"
    path.write_text(GLOW_YAML.replace("EPOCHS", "0").replace("baseline_VAE", "eval"))
    cfg = run.load_cfg(str(path))
    cfg.model_dir = str(tmp_path / "a") + "/"
    exp = engine.Experiment(cfg, device="cpu")
    assert exp in engine.Experiment._live and exp.log.handlers
    engine.close_all_experiments()
    assert exp.writer._jsonl.closed and not exp.log.handlers
    exp.close()  # idempotent
    cfg.model_dir = str(tmp_path / "b") + "/"
    jsonl = engine.Experiment(cfg, device="cpu").writer._jsonl
    gc.collect()
    assert jsonl.closed  # the finaliser closed the sinks of the dropped instance
    assert (tmp_path / "b" / "info_eval.log").is_file()
