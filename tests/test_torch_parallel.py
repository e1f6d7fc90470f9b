"""The port's parallel paths (mhentropy_tpu_torch/parallel/, the sharded
steps of train/engine.py, export.ShardedSampler) in a 2-rank gloo group on
the CPU, against JAX's 2-device mesh and the port's 1-process run.

One process group for the whole file (a module fixture): it runs every
case and returns rank 0's results; each test asserts on its part. The model
is tests/test_engine.py's small_cfg (resnet18 at 32 px, RealNVP 1 x 2 x 32,
f32, 8 images, 2 train hypotheses), its weights JAX's init carried by
`convert.from_jax`, its batch JAX's synthetic one, its base noise JAX's
(`jax.random.normal(key, (2 * 8, 45))` is what JAX's step draws).

Tolerances:
* against JAX's 2-device step, JAX's own for 1 against 8 devices
  (tests/test_engine.py:74-76): loss relative 1e-4, det_head weights 1e-4
  after one step at lr 1e-3;
* against the port's 1-process step: the same two, and the global gradient
  (what the ranks' summed gradients must be, train-mode BN over the global
  batch included) within 1e-4 of each tensor's largest entry, for both
  BN-sum autograd structures and the plain statistics; FSDP's second step
  at JAX's 1e-2 (Adam amplifies the first step's rounding);
* the f32 sampler's autograd route under TP against the 1-process plain
  draw: the gradients within 1e-4 of each tensor's largest entry;
* the sharded eval (hypotheses over 'hypo', images over 'data', TP over
  'model', a top-test_quant filter over hypo ranks) and the sharded
  export: 1e-5 relative (the same products in another order or split);
* ZeRO-3 (`tpu.fsdp`) against data parallelism in the same group after
  two steps: weights within 1e-6 and Adam moments within 1e-4 of each
  tensor's largest entry (the phase 9h gate);
* the glow regressor at tp = 2 against its 1-process step and eval: the
  DP glow case's tolerances;
* the RLE mode on 2 data ranks (resnet18 at 32 px, B = 4, the per-joint
  flow of tests/test_torch_rle.py, the last image padding): against JAX's
  2-device `make_rle_train_step`, loss and sigma_i within 1e-3 relative a
  step (tests/test_torch_rle.py's train tolerance); against the port's
  1-process steps, aux 1e-4 relative, the global gradient 1e-4 of each
  tensor's largest entry, the eval metrics 1e-5 relative;
* the Experiment (glow at tp = 2, the RLE mode on 2 data ranks, 2 hypo
  ranks with test_quant) against its 1-process run: 1e-3 relative, the
  two-rank Experiment's tolerance.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models import rle as jrle
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.models.mhent import MHEntConfig as JMHEntConfig
from mhentropy_tpu.parallel import mesh as jmesh
from mhentropy_tpu.parallel import multihost as jmultihost
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu_torch.convert import from_jax, rle_from_jax
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.flows import glow
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent, rle
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from mhentropy_tpu_torch.parallel import multihost
from mhentropy_tpu_torch.parallel import sharded
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.train.engine import Experiment
from mhentropy_tpu_torch.utils.config import load_cfg
from tests import torch_dist
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

IMG, B, N, LR = 32, 8, 4, 1e-3
MODES = ("stats", "full", "plain")
RLE_B, RLE_LR = 8, 1e-6
RLE_FLOW = dict(dim=3, h_dim=32, num_steps=2, joint_n=21, tsfm_on="x")

EXPERIMENT_YAML = """\
dataset: {{dataset_name: ho3d, image_size: [{img}, {img}]}}
network: {{enc_type: MHEnt, backbone: resnet18, num_latent: 32, h_dims: [32, 32],
          num_steps: 1}}
training: {{mode: baseline_VAE, epochs: 1, batch_size: 8, seed: 3, lr: 0.0001,
           test_samples: 4, n_train_hypotheses: 2}}
info_interval: 1
tpu: {{compute_dtype: float32}}
"""


# The Experiment's layouts this slice opened, each as its 1-process run
# ({par} empty) and on the 2-rank group.
LAYOUT_YAMLS = {
    "glow_tp": ("dataset: {{dataset_name: ho3d, image_size: [32, 32]}}\n"
                "network: {{enc_type: MHEnt, regressor: glow, num_latent: 16, backbone: resnet18,"
                " glow_hidden: 32, glow_layers: 2, glow_blocks: 2}}\n"
                "training: {{mode: baseline_VAE, batch_size: 8, epochs: 1, test_samples: 2, "
                "seed: 1, n_train_hypotheses: 2, lr: 0.0001}}\n"
                "info_interval: 2\ntpu: {{compute_dtype: float32{par}}}\n"),
    "rle": ("dataset: {{dataset_name: rhd, image_size: [32, 32], pe: 3d, jointN: 21}}\n"
            "network: {{enc_type: BasicEnc, num_latent: 63, backbone: resnet18, p_nf: realnvp,"
            " p_nf_dim: 3, tsfm_on: x, h_dims: [32, 32], num_steps: 2, nf_res: rle}}\n"
            "training: {{mode: baseline_VAE, batch_size: 8, epochs: 1, lr: 0.0001, seed: 2,"
            " test_samples: 1}}\n"
            "info_interval: 2\ntpu: {{compute_dtype: float32{par}}}\n"),
    "hypo_quant": EXPERIMENT_YAML.replace("{img}", "32").replace(
        "epochs: 1,", "epochs: 0, test_quant: 2,").replace(
        "tpu: {{compute_dtype: float32}}", "tpu: {{compute_dtype: float32{par}}}"),
}
LAYOUT_PAR = {"glow_tp": ", tp: 2", "rle": "", "hypo_quant": ", mesh_hypo: 2"}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _close_to_largest(got, want, share, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= share * max(np.abs(want).max(), 1e-12), (name, err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = JMHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=1),
        feat_dim=32, image_size=IMG, n_train_hypotheses=2)
    jmodel = jmano.synthetic_mano_model(0)
    optimizer = jengine.make_optimizer(LR, [100], steps_per_epoch=10)
    data = jsynthetic.make_dataset(jmodel, n=B, image_size=IMG, seed=1)
    image, target = next(jsynthetic.batches(data, B))
    # Jitted, the init compiles once instead of op by op (the same values).
    state = jax.jit(lambda k: jengine.init_state(k, jcfg, optimizer))(jax.random.key(0))
    init = from_jax(jax.tree.map(np.asarray, state.params),
                    jax.tree.map(np.asarray, state.batch_stats))
    rng = np.random.RandomState(3)
    inputs = dict(
        cfg=torch_dist.small_cfg(IMG), state=init, lr=LR, n=N,
        image=np.array(image), target={k: np.array(v) for k, v in target.items()},
        noise=np.stack([np.array(jax.random.normal(jax.random.key(k), (2 * B, 45)))
                        for k in (7, 8)]),
        kld_noise=rng.randn(2 * B, 45).astype(np.float32),
        hypo_noise=(rng.randn(N * B, 45) * 0.8).astype(np.float32),
        draw_feat=rng.randn(B, 16).astype(np.float32),
        draw_w=(rng.randn(32, 16) * 0.25).astype(np.float32),
        draw_b=(rng.randn(32) * 0.1).astype(np.float32))
    tmp = tmp_path_factory.mktemp("parallel")
    yaml = tmp / "exp.yaml"
    yaml.write_text(EXPERIMENT_YAML.format(img=IMG))
    inputs.update(yaml=str(yaml), model_dir=str(tmp / "two_ranks"), mh_n=13, mh_batch=4,
                  n_quant=2)
    # load_model on ZeRO-3 (its 1-process run beside): a .pth of another seed.
    for where, par in (("two_ranks", ", fsdp: true"), ("one_rank", "")):
        (tmp / f"load_{where}.yaml").write_text(EXPERIMENT_YAML.format(img=IMG).replace(
            "tpu: {compute_dtype: float32}", "tpu: {compute_dtype: float32" + par + "}"))
    pth = tmp / "load.pth"
    torch.save({"encoderRGB": mhent.init(engine.build_model_config(
        load_cfg(str(tmp / "load_one_rank.yaml"))), seed=5).state_dict()}, pth)
    inputs["load"] = {"yaml": str(tmp / "load_two_ranks.yaml"), "pth": str(pth),
                      "model_dir": str(tmp / "load_two") + "/"}
    gcfg = inputs["cfg"]._replace(regressor="glow", glow_hidden=16, glow_layers=2)
    inputs["glow"] = {"cfg": gcfg, "state": mhent.init(gcfg, seed=2).state_dict()}
    bn_cfg = glow.GlowConfig(features=45, hidden=32, num_layers=2, num_blocks=2,
                             context_features=16, dropout=0.2, use_batch_norm=True)
    bn_flow = glow.ConditionalGlow(bn_cfg)
    bn_flow.init_params(torch.Generator().manual_seed(4))
    inputs["glow_bn"] = {"cfg": bn_cfg, "state": bn_flow.state_dict(),
                         "x": rng.randn(B, 45).astype(np.float32),
                         "ctx": rng.randn(B, 16).astype(np.float32)}
    rle_in, jrle_run = _rle_inputs()
    inputs["rle"] = rle_in
    inputs["experiments"] = {}
    for name, text in LAYOUT_YAMLS.items():
        for where, par in (("two_ranks", LAYOUT_PAR[name]), ("one_rank", "")):
            path = tmp / f"{name}_{where}.yaml"
            path.write_text(text.format(par=par))
            if where == "two_ranks":
                inputs["experiments"][name] = (str(path), str(tmp / f"{name}_two"))
    # The group runs while this process makes the export artifact and
    # computes the 1-process references, in a thread beside JAX's steps
    # (which compile meanwhile) and on fewer threads to leave the group
    # cores.
    group = torch_dist.Group(2, ["dp", "dp_glow", "fsdp", "tp", "tp_draw", "eval", "export",
                                 "experiment", "multihost", "glow_tp", "glow_bn_tp", "rle",
                                 "experiments", "load_model"],
                             inputs)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(_port_side, group, inputs, tmp, yaml)
            mesh = jmesh.make_mesh(n_devices=2, hypo=1)
            step = jengine.make_train_step(jmodel, jcfg, optimizer, mesh)
            new, aux = step(state, jmesh.shard_batch(mesh, image),
                            jmesh.shard_batch(mesh, target), jax.random.key(7))
            jax_out = {"loss": float(aux["loss"]),
                       "det_head.0.weight": np.asarray(new.params["det_head"]["l0"]["w"]).T,
                       "rle": jrle_run()}
            one = port.result()
    except BaseException:
        group.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    return inputs, jax_out, group.results(), one


def _rle_inputs():
    """The RLE case's inputs (JAX's init at tests/test_torch_rle.py's flow,
    resnet18 at 32 px, a synthetic batch of RLE_B whose last image is
    padding, the draws of JAX's keys) and a function that runs two steps of
    JAX's make_rle_train_step on a 2-device mesh from the same state."""
    enc = dict(backbone="resnet18", n_latent=(63, 63), dtype="float32")
    jcfg = jrle.RLEConfig(encoder=JEncoderConfig(**enc), flow=JRealNVPConfig(**RLE_FLOW),
                          pe="3d", k1=10, nf_res="rle", image_size=IMG)
    cfg = rle.RLEConfig(encoder=EncoderConfig(**enc), flow=RealNVPConfig(**RLE_FLOW), pe="3d",
                        k1=10, nf_res="rle", image_size=IMG)
    params, stats = jax.jit(lambda k: jrle.init(k, jcfg))(jax.random.key(0))
    params, stats = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats)
    data = jsynthetic.make_dataset(jmano.synthetic_mano_model(0), n=RLE_B, image_size=IMG,
                                   seed=2, ds="rhd")
    image = np.array(data.images[:RLE_B])
    target = {k: np.array(v[:RLE_B]) for k, v in data.targets.items()}
    target["valid"] = np.array([1.0] * (RLE_B - 1) + [0.0], np.float32)
    keys = [jax.random.key(30 + i) for i in range(2)]

    def draws(key):
        # The two draws JAX's loss_and_predict splits from its key.
        k_noise, k_sample = jax.random.split(key)
        pose = target["pose3d"]
        rows = pose.shape[0] * pose.shape[1] // 3
        base = np.stack([np.array(jax.random.normal(jax.random.fold_in(k_sample, i), (rows, 3)))
                         * jcfg.sample_temp for i in range(jcfg.k1)])
        return np.array(jax.random.normal(k_noise, pose.shape)), base.astype(np.float32)

    inputs = dict(cfg=cfg, state=rle_from_jax(params, stats), lr=RLE_LR, image=image,
                  target=target, draws=[draws(k) for k in keys],
                  eval_draws=draws(jax.random.key(40)))

    def run():
        optimizer = jengine.make_optimizer(RLE_LR, [1], steps_per_epoch=1)
        mesh = jmesh.make_mesh(n_devices=2)
        state = jengine.TrainState(params, stats, optimizer.init(params),
                                   jax.numpy.zeros((), jax.numpy.int32))
        step = jengine.make_rle_train_step(jcfg, optimizer, mesh)
        auxes = []
        for k in keys:
            state, aux = step(state, jmesh.shard_batch(mesh, image),
                              jmesh.shard_batch(mesh, target), k)
            auxes.append({n: float(v) for n, v in aux.items()})
        return auxes

    return inputs, run


def _port_side(group, inputs, tmp, yaml):
    """Sends the group the export artifact; returns the port's 1-process
    results."""
    group.send("export", torch_dist.export_blob(inputs, 2))
    glow = dict(inputs, **inputs["glow"])
    one = {"dp": {m: torch_dist.train_once(inputs, bn_mode="stats" if m == "plain" else m,
                                           kernels=m != "plain") for m in MODES},
           "dp_glow": torch_dist.train_once(glow),
           "glow_eval": torch_dist.eval_once(glow),
           "fsdp": torch_dist.train_once(inputs, steps=2),
           "eval": torch_dist.eval_once(inputs),
           "eval_quant": torch_dist.eval_once(inputs, n_quant=inputs["n_quant"]),
           "draw": torch_dist.draw_grads(inputs, fused=False),
           "rle": torch_dist.rle_once(inputs),
           "glow_bn": torch_dist.glow_bn_once(inputs)}
    cfg = load_cfg(str(yaml))
    cfg.model_dir = str(tmp / "one_rank")
    with Experiment(cfg, device="cpu") as exp:
        one["experiment"] = exp.train_baseline()
    cfg = load_cfg(str(tmp / "load_one_rank.yaml"))
    cfg.model_dir = str(tmp / "load_one") + "/"
    with Experiment(cfg, device="cpu") as exp:
        exp._ensure_state(4)
        one["load_model"] = {
            "state": {k: v.detach().clone() for k, v in exp.net.state_dict().items()},
            "models_txt": open(tmp / "load_one" / "models.txt").read()}
    one["experiments"] = {}
    for name in LAYOUT_YAMLS:
        cfg = load_cfg(str(tmp / f"{name}_one_rank.yaml"))
        cfg.model_dir = str(tmp / f"{name}_one")
        with Experiment(cfg, device="cpu") as exp:
            one["experiments"][name] = exp.train_baseline()
    return one


def test_dp_step_matches_jax_two_device_step(setup):
    _, jax_out, results, _ = setup
    got = results["dp"]["stats"]
    assert _rel(got["aux"][0]["loss"], jax_out["loss"]) < 1e-4
    np.testing.assert_allclose(got["state"]["det_head.0.weight"].numpy(),
                               jax_out["det_head.0.weight"], atol=1e-4)


@pytest.mark.parametrize("mode", MODES + ("glow",))
def test_dp_step_matches_one_process_step(setup, mode):
    """Train-mode BN over the global batch: the gradient is the 1-process
    step's; per-rank statistics would leave the loss close and part the
    backbone's gradients. "glow": the glow regressor, whose dropout masks
    the ranks draw for the global batch."""
    _, _, results, one = setup
    got, want = (results["dp_glow"], one["dp_glow"]) if mode == "glow" else (
        results["dp"][mode], one["dp"][mode])
    for k in want["aux"][0]:
        assert _rel(got["aux"][0][k], want["aux"][0][k]) < 1e-4, k
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        _close_to_largest(got["grads"][k], g, 1e-4, k)
    np.testing.assert_allclose(got["state"]["det_head.0.weight"],
                               want["state"]["det_head.0.weight"], atol=1e-4)
    for k, v in want["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_fsdp_steps_match_dp(setup):
    """ZeRO-3's two steps against the 1-process run (JAX's tolerances, as
    the DP case), and against data parallelism in the same group: every
    weight within 1e-6 and every Adam moment within 1e-4 of its tensor's
    largest entry."""
    _, _, results, one = setup
    got, want, dp = results["fsdp"]["zero3"], one["fsdp"], results["fsdp"]["dp"]
    assert _rel(got["aux"][0]["loss"], want["aux"][0]["loss"]) < 1e-4
    assert _rel(got["aux"][1]["loss"], want["aux"][1]["loss"]) < 1e-2
    np.testing.assert_allclose(got["state"]["det_head.0.weight"],
                               want["state"]["det_head.0.weight"], atol=1e-2)
    assert set(got["state"]) == set(dp["state"])
    for k, v in dp["state"].items():
        if v.is_floating_point():
            _close_to_largest(got["state"][k], v, 1e-6, k)
    mine, ref = got["opt"]["adam"]["state"], dp["opt"]["adam"]["state"]
    assert set(mine) == set(ref) and ref
    for i, st in ref.items():
        for m in ("exp_avg", "exp_avg_sq"):
            _close_to_largest(mine[i][m], st[m], 1e-4, (i, m))


def test_fsdp_shards_the_state(setup):
    """Between steps every parameter of at least 4096 elements is stored
    split over the 2 data ranks, and so are its gradient and Adam's
    moments: half the whole numel each."""
    inputs, _, results, _ = setup
    net = mhent.MHEnt(inputs["cfg"])
    big = {k for k, p in net.named_parameters() if p.numel() >= 4096}
    stored = results["fsdp"]["zero3"]["stored"]
    assert big and set(stored) == big
    assert sum("grad" in v for v in stored.values()) > len(big) // 2
    for k, p in net.named_parameters():
        if k in big:
            # The sigma head, which no loss reads, has no gradient.
            keys = ("param", "grad", "exp_avg", "exp_avg_sq") if "grad" in stored[k] else \
                ("param",)
            assert stored[k] == dict.fromkeys(keys, p.numel() // 2), k


def test_fsdp_checkpoint_restores_into_replicated_layout(setup):
    """The gathered weights and optimizer state load into a 1-process MHEnt
    and Optimizer bit-exactly (after two steps), and after the first step
    the gathered Adam moments are the 1-process run's, to 1e-4 of each
    tensor's largest entry (the gradient's tolerance); the gathered
    gradients of the second step, in the 1-process layout, are data
    parallelism's in the same group within 1e-6 of each tensor's largest
    entry."""
    inputs, _, results, one = setup
    got = results["fsdp"]["zero3"]
    net = mhent.MHEnt(inputs["cfg"])
    net.load_state_dict(got["state"], strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, got["state"][k]), k
    opt = engine.make_optimizer(net, LR, [100], 10)
    opt.load_state_dict(got["opt"])
    assert opt.count == 2
    for i, (k, p) in enumerate(net.named_parameters()):
        st = opt.adam.state.get(p)
        if st:
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[m], got["opt"]["adam"]["state"][i][m]), k
                assert st[m].shape == p.shape, k
    first, ref = got["opt_first"]["adam"]["state"], one["fsdp"]["opt_first"]["adam"]["state"]
    assert set(first) == set(ref) and ref
    for i, st in ref.items():
        for m in ("exp_avg", "exp_avg_sq"):
            _close_to_largest(first[i][m], st[m], 1e-4, (i, m))
    dp = results["fsdp"]["dp"]["grads"]
    assert set(got["grads"]) == set(dp) and dp
    for k, g in dp.items():
        assert got["grads"][k].shape == g.shape, k
        _close_to_largest(got["grads"][k], g, 1e-6, k)


def test_tp_step_matches_one_process_step(setup):
    _, _, results, one = setup
    got, want = results["tp"], one["dp"]["stats"]
    for k in want["aux"][0]:
        assert _rel(got["aux"][0][k], want["aux"][0][k]) < 1e-4, k
    for k, g in want["grads"].items():
        _close_to_largest(got["grads"][k], g, 1e-4, k)
    np.testing.assert_allclose(got["state"]["det_head.0.weight"],
                               want["state"]["det_head.0.weight"], atol=1e-4)
    for k, v in want["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_tp_stores_each_split_parameter_as_its_half(setup):
    """Under tp = 2 each `_tp_spec` parameter, its gradient and its Adam
    moments are stored as this rank's half; no other parameter is split."""
    inputs, _, results, _ = setup
    net = mhent.MHEnt(inputs["cfg"])
    split = _tp_names(net)
    stored = results["tp"]["stored"]
    assert split and set(stored) == split
    for k, p in net.named_parameters():
        if k in split:
            assert stored[k] == dict.fromkeys(("param", "grad", "exp_avg", "exp_avg_sq"),
                                              p.numel() // 2), k


def _tp_names(net, n=2) -> set:
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    return {k for k, s in shapes.items() if mesh_lib._tp_spec(k, s, n) is not None}


def test_tp_f32_sampler_route_gradients_match_one_process(setup):
    """The train step's draw through the f32 sampler's autograd route
    (`TransformDiff`: whole forward, split recompute in the backward) under
    tp = 2 gives the 1-process plain draw's gradients, the replicated layer
    before the flow's included (its cotangent through the c.0 projections
    summed over 'model')."""
    _, _, results, one = setup
    got, want = results["tp_draw"]["grads"], one["draw"]
    assert set(got) == set(want) and "layer.weight" in want
    for k, g in want.items():
        _close_to_largest(got[k], g, 1e-4, k)


def test_tp_f32_draw_without_gradients_packs_the_gathered_weights_once(setup):
    """The eval's reverse-KL draw (no gradients) with the flow stored split
    over tp = 2 ranks: the autograd route's draw bit for bit, and a second
    call reuses the pack of the gathered weights."""
    _, _, results, _ = setup
    got = results["tp_draw"]["no_grad"]
    assert got["reused"]
    for a, b, c in zip(got["no_grad"], got["again"], got["grad"]):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("layout", ["hypo", "data", "tp", "hypo_quant"])
def test_sharded_eval_matches_one_process(setup, layout):
    """"hypo_quant": the top-2-of-4 test_quant filter with the hypotheses
    over 2 hypo ranks, against one process's filter."""
    _, _, results, one = setup
    got = results["eval"][layout]
    want = one["eval_quant"] if layout == "hypo_quant" else one["eval"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1.0), (k, got[k], v)


def test_glow_tp_step_matches_one_process_step(setup):
    """The glow regressor at tp = 2 (its ResidualNet blocks split, the
    context gate gathered, the dropout masks one process's columns)
    against the 1-process step: the DP glow case's tolerances."""
    _, _, results, one = setup
    got, want = results["glow_tp"]["train"], one["dp_glow"]
    for k in want["aux"][0]:
        assert _rel(got["aux"][0][k], want["aux"][0][k]) < 1e-4, k
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        _close_to_largest(got["grads"][k], g, 1e-4, k)
    np.testing.assert_allclose(got["state"]["det_head.0.weight"],
                               want["state"]["det_head.0.weight"], atol=1e-4)
    split = {k for k in got["stored"] if ".transform_net.blocks." in k}
    assert split and all(".linear_layers." in k or ".context_layer." in k for k in split)
    for k in split:
        assert got["stored"][k]["param"] * 2 == want["state"][k].numel(), k


def test_glow_tp_eval_matches_one_process(setup):
    _, _, results, one = setup
    got, want = results["glow_tp"]["eval"], one["glow_eval"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1.0), (k, got[k], v)


def test_glow_hidden_batchnorm_under_tp_matches_one_process(setup):
    """A Glow whose coupling nets hold BatchNorm, at tp = 2: the hidden
    BatchNorm runs on each rank's columns (its scale and bias whole, their
    gradients summed over 'model'), the dropout masks are one process's
    columns, and `bn_stats_update`'s running statistics, gathered by
    `sync_split_stats`, are the 1-process ones; the DP glow case's
    tolerances (1e-4 of each tensor's largest entry, statistics 1e-4
    relative). The bias of the Linear ahead of the hidden BatchNorm has a
    gradient of 0 in exact arithmetic (train-mode BN removes its mean):
    both runs hold rounding there, held to 1e-6 absolute."""
    _, _, results, one = setup
    got, want = results["glow_bn_tp"], one["glow_bn"]
    _close_to_largest(got["log_p"], want["log_p"], 1e-5, "log_p")
    assert set(got["grads"]) == set(want["grads"])
    assert any("batch_norm_layers.1" in k for k in want["grads"])
    for k, g in want["grads"].items():
        if k.endswith("linear_layers.0.bias"):
            assert np.abs(np.asarray(got["grads"][k]) - np.asarray(g)).max() <= 1e-6, k
            continue
        _close_to_largest(got["grads"][k], g, 1e-4, k)
    for k, v in want["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_rle_dp_steps_match_jax_two_device_step(setup):
    _, jax_out, results, _ = setup
    got = results["rle"]["aux"]
    assert len(got) == len(jax_out["rle"]) == 2
    for mine, theirs in zip(got, jax_out["rle"]):
        for k in ("loss", "sigma_i"):
            assert _rel(mine[k], theirs[k]) < 1e-3, (k, mine[k], theirs[k])


def test_rle_dp_steps_and_eval_match_one_process(setup):
    """Two RLE train steps on 2 data ranks (BN over the global batch, the
    padded image masked over the global valid count) and an eval step."""
    _, _, results, one = setup
    got, want = results["rle"], one["rle"]
    for g, w in zip(got["aux"], want["aux"]):
        for k in w:
            assert _rel(g[k], w[k]) < 1e-4, k
    assert set(got["grads"]) == set(want["grads"]) and want["grads"]
    for k, g in want["grads"].items():
        _close_to_largest(got["grads"][k], g, 1e-4, k)
    for k, v in want["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    assert set(got["eval"]) == set(want["eval"]) and "sigma_i" in want["eval"]
    for k, v in want["eval"].items():
        assert abs(got["eval"][k] - v) <= 1e-5 * max(abs(v), 1.0), (k, got["eval"][k], v)


@pytest.mark.parametrize("name", sorted(LAYOUT_YAMLS))
def test_experiment_layouts_on_two_ranks_match_one_process(setup, name):
    """run.py's Experiment with tpu.tp 2 on the glow regressor, the RLE
    mode on 2 data ranks, and tpu.mesh_hypo 2 with training.test_quant: the
    last eval's summary is the 1-process run's."""
    _, _, results, one = setup
    got, want = results["experiments"][name], one["experiments"][name]
    assert set(got) == set(want) and want
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3 * max(abs(v), 1.0), (k, got[k], v)


def test_load_model_on_zero3_loads_the_named_modules(setup):
    """load_model(mod_names=["det_head", "q_z_giv_i"]) on the 2-rank ZeRO-3
    Experiment, queued before its state: through the layout's load hook
    each rank stores its block of the .pth's modules; gathered, the named
    modules are the .pth's and the backbone is the Experiment's own (its
    1-process run's). Rank 0's models.txt counts the whole tensors: the
    1-process run's file."""
    inputs, _, results, one = setup
    got, want = results["load_model"], one["load_model"]
    ckpt = torch.load(inputs["load"]["pth"])["encoderRGB"]
    assert got["split"] > 0 and set(got["state"]) == set(want["state"])
    for k, v in got["state"].items():
        ref = ckpt[k] if k.split(".", 1)[0] in ("det_head", "q_z_giv_i") else want["state"][k]
        assert torch.equal(v, ref), k
    assert got["models_txt"] == want["models_txt"]


def test_sharded_export_matches_live_call(setup):
    _, _, results, _ = setup
    got, want = results["export"]["served"], results["export"]["live"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_experiment_on_two_ranks_matches_one_process(setup):
    """run.py's Experiment on the group: the global batches and noise on
    every rank, each rank's share of each step; rank 0 writes."""
    inputs, _, results, one = setup
    got = results["experiment"]
    want = one["experiment"]
    assert set(got["summary"]) == set(want)
    for k, v in want.items():
        assert abs(got["summary"][k] - v) <= 1e-3 * max(abs(v), 1.0), (k, got["summary"][k], v)
    for name in ("baseline_mano_0.pth", "baseline_final.pth", "info_baseline_VAE.log",
                 "scalars.jsonl"):
        assert name in got["files"], got["files"]


@pytest.mark.parametrize("n,pc", [(13, 4), (16, 4), (3, 2), (1, 3)])
def test_host_shards_match_jax(n, pc):
    """host_shard_indices / _valid / wrap_padded equal JAX's; every sample
    is served by exactly one valid slot."""
    for pi in range(pc):
        np.testing.assert_array_equal(multihost.host_shard_indices(n, pi, pc),
                                      jmultihost.host_shard_indices(n, pi, pc))
        np.testing.assert_array_equal(multihost.host_shard_valid(n, pi, pc),
                                      jmultihost.host_shard_valid(n, pi, pc))
    assert multihost.wrap_padded(n, pc) == jmultihost.wrap_padded(n, pc)
    valid_idx = np.concatenate([multihost.host_shard_indices(n, pi, pc)[
        multihost.host_shard_valid(n, pi, pc)] for pi in range(pc)])
    assert sorted(valid_idx.tolist()) == list(range(n))


def test_multihost_batches_on_two_ranks(setup):
    """Each rank reads its slice; the ranks' batches together cover every
    sample once as valid, and the wrapped duplicate is masked."""
    inputs, _, results, _ = setup
    batches = results["multihost"]["batches"]
    assert len(batches) == 4  # 7 slots a rank: 4 local batches of 2, the last padded
    valid = torch.cat([v for _, v in batches])
    assert int(valid.sum()) == inputs["mh_n"]
    np.testing.assert_array_equal(results["multihost"]["rank_indices"],
                                  multihost.host_shard_indices(inputs["mh_n"], 0, 2))


def test_global_batch_from_local_is_the_ranks_shard(setup):
    """Each rank's local batch (its rows in rank order) comes back as that
    rank's shard of the global batch, on a data mesh and on a hypo mesh
    (whose ranks share a shard)."""
    _, _, results, _ = setup
    assert results["multihost"]["global_from_local"] == {"data": [True, True],
                                                         "hypo": [True, True]}


def test_global_batch_from_local_in_one_process():
    image, target = torch_dist.numpy_batch(4, 16, seed=6)
    mesh = mesh_lib.make_mesh()
    got = multihost.global_batch_from_local(mesh, (image, target), global_batch_size=4)
    want = mesh_lib.shard_batch(mesh, (torch.from_numpy(image),
                                       {k: torch.from_numpy(v) for k, v in target.items()}))
    assert torch.equal(got[0], want[0])
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k
    with pytest.raises(ValueError, match="global batch 8"):
        multihost.global_batch_from_local(mesh, (image, target), global_batch_size=8)


def test_multihost_batches_single_process_equivalence():
    """One process: multihost_batches is the plain loader."""
    from mhentropy_tpu_torch.data import common, synthetic

    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=10, image_size=16, seed=5)
    got = list(multihost.multihost_batches(data, 4, pad_remainder=True))
    want = list(common.batches(data, 4, pad_remainder=True))
    assert len(got) == len(want) == 3
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_allclose(np.asarray(gi), np.asarray(wi), atol=1e-6)
        np.testing.assert_allclose(np.asarray(gt["valid"]), np.asarray(wt["valid"]))
        np.testing.assert_allclose(np.asarray(gt["pose3d"]), np.asarray(wt["pose3d"]), atol=1e-6)


def test_multihost_batches_masks_wrap_duplicates_without_pad(monkeypatch):
    """A shard that wraps twice over 10 samples: the duplicates land in
    full batches, and pad_remainder=False still masks them."""
    from mhentropy_tpu_torch.data import synthetic

    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=10, image_size=16, seed=5)
    monkeypatch.setattr(multihost, "_host_slice",
                        lambda n, pi, pc: (np.arange(12) % n, np.arange(12) < n))
    got = list(multihost.multihost_batches(data, 4, pad_remainder=False))
    assert len(got) == 3
    valid = np.concatenate([np.asarray(t["valid"]) for _, t in got])
    np.testing.assert_array_equal(valid, (np.arange(12) < 10).astype(np.float32))


def test_initialize_raises_on_explicit_or_multinode_failure(monkeypatch):
    """An explicit bring-up, and torchrun's multi-node signals, raise when
    joining fails; a bare single process runs undistributed."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)

    def boom(*args, **kwargs):
        raise RuntimeError("no rendezvous reachable")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError):
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=0, device_type="cpu")
    multihost.initialize(device_type="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    multihost.initialize(device_type="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError):
        multihost.initialize(device_type="cpu")


@pytest.mark.parametrize("b,hypo,tp,pp,avail", [(8, 1, 1, 1, 8), (6, 1, 1, 1, 8),
                                                (2, 2, 1, 1, 8), (4, 1, 2, 2, 8),
                                                (3, 1, 1, 1, 4), (8, 4, 1, 1, 2)])
def test_fit_devices_matches_jax(b, hypo, tp, pp, avail):
    try:
        want = jmesh.fit_devices(b, hypo=hypo, tp=tp, pp=pp, n_available=avail)
    except ValueError as e:
        with pytest.raises(ValueError, match="exceeds"):
            mesh_lib.fit_devices(b, hypo=hypo, tp=tp, pp=pp, n_available=avail)
        assert "exceeds" in str(e)
        return
    assert mesh_lib.fit_devices(b, hypo=hypo, tp=tp, pp=pp, n_available=avail) == want


def test_make_mesh_in_one_process():
    mesh = mesh_lib.make_mesh()
    assert mesh.shape == {"data": 1, "hypo": 1, "model": 1, "pipe": 1}
    assert mesh.group("data") is None and mesh.device_mesh is None
    with pytest.raises(ValueError, match="ranks"):
        mesh_lib.make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="divide"):
        mesh_lib.make_mesh(hypo=2)


def test_tp_and_fsdp_rules_cover_jax_leaves():
    """The port's rules split the parameters JAX's split, along the
    matching dims (torch weights are (out, in), JAX kernels (in, out))."""
    cfg = torch_dist.small_cfg(IMG)
    net = mhent.MHEnt(cfg)
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}

    class FakeMesh:
        shape = {"data": 2, "hypo": 1, "model": 2, "pipe": 1}

    spec = mesh_lib.state_sharding(FakeMesh, shapes, fsdp=True, tp=True)
    tp = {k: v["model"] for k, v in spec.items() if v["model"] is not None}
    assert tp["q_z_giv_i.s.0.l.0.weight"] == 0 and tp["q_z_giv_i.t.1.c.0.bias"] == 0
    assert tp["q_z_giv_i.s.1.l.1.weight"] == 1 and "q_z_giv_i.s.0.l.2.weight" not in tp
    assert "q_z_giv_i.s.0.c.1.weight" not in tp
    assert tp["feat_extractor.res.layer1.0.conv1.weight"] == 0
    assert tp["feat_extractor.res.layer1.0.bn1.weight"] == 0
    assert tp["feat_extractor.res.layer3.1.conv2.weight"] == 1
    assert "feat_extractor.res.conv1.weight" not in tp
    assert "feat_extractor.res.layer2.0.downsample.0.weight" not in tp
    assert tp["det_head.0.weight"] == 0 and tp["det_head.0.bias"] == 0
    assert tp["det_head.2.weight"] == 1 and "det_head.2.bias" not in tp
    # JAX's rule on the same model: each split flow / det leaf in JAX has a
    # split port parameter.
    jcfg = JMHEntConfig(
        encoder=JEncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=JRealNVPConfig(dim=45, cond_dim=32, h_dim=32, num_steps=1), feat_dim=32,
        image_size=IMG)
    from mhentropy_tpu.models import mhent as jmhent

    params = jax.eval_shape(lambda k: jmhent.init(k, jcfg)[0], jax.random.key(0))
    jax_split = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = jax.tree_util.keystr(path)
        if jmesh._tp_spec(name, leaf.shape, 2) is not None:
            jax_split.add(name.split(".")[-1].strip("']"))
    assert {"s_w0", "s_w1", "t_w0", "t_c0"} <= jax_split
    for k, v in spec.items():
        if v["data"] is not None:
            assert int(np.prod(shapes[k])) >= 4096 and v["data"] != v["model"], k


@pytest.mark.parametrize("fsdp,tp", [(True, False), (False, True), (True, True)])
def test_shard_index_matches_jax_devices_indices_map(fsdp, tp):
    """Every rank's block of every parameter under the port's layout
    (`mesh.shard_index`) is the block that JAX's `NamedSharding(mesh,
    spec).devices_indices_map(shape)` gives the device at the same mesh
    coordinates: 8 CPU devices as (data 2, hypo 1, model 2, pipe 2), spec
    the port's split dims named by their axes. Nothing is compiled."""
    from jax.sharding import NamedSharding, PartitionSpec

    jm = jmesh.make_mesh(n_devices=8, tp=2, pp=2)

    class FakeMesh:
        shape = dict(zip(mesh_lib.AXES, jm.devices.shape))

    net = mhent.MHEnt(torch_dist.small_cfg(IMG))
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    spec = mesh_lib.state_sharding(FakeMesh, shapes, fsdp=fsdp, tp=tp)
    split = 0
    for name, shape in shapes.items():
        axes = [None] * len(shape)
        for axis in ("model", "data"):
            if spec[name][axis] is not None:
                axes[spec[name][axis]] = axis
        split += any(axes)
        dmap = NamedSharding(jm, PartitionSpec(*axes)).devices_indices_map(shape)
        for coord in np.ndindex(jm.devices.shape):
            got = mesh_lib.shard_index(FakeMesh, name, shape, fsdp=fsdp, tp=tp,
                                       coords=dict(zip(mesh_lib.AXES, coord)))
            want = dmap[jm.devices[coord]]
            assert [s.indices(n) for s, n in zip(got, shape)] == \
                [s.indices(n) for s, n in zip(want, shape)], (name, coord)
    assert split > 10
