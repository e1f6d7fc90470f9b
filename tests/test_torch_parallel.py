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
  'model') and the sharded export: 1e-5 relative (the same products in
  another order or split).
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from mhentropy_tpu.core import mano as jmano
from mhentropy_tpu.data import synthetic as jsynthetic
from mhentropy_tpu.flows.realnvp import RealNVPConfig as JRealNVPConfig
from mhentropy_tpu.models.encoder import EncoderConfig as JEncoderConfig
from mhentropy_tpu.models.mhent import MHEntConfig as JMHEntConfig
from mhentropy_tpu.parallel import mesh as jmesh
from mhentropy_tpu.parallel import multihost as jmultihost
from mhentropy_tpu.train import engine as jengine
from mhentropy_tpu_torch.convert import from_jax
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from mhentropy_tpu_torch.parallel import multihost
from mhentropy_tpu_torch.train import engine
from mhentropy_tpu_torch.train.engine import Experiment
from mhentropy_tpu_torch.utils.config import load_cfg
from tests import torch_dist

IMG, B, N, LR = 32, 8, 4, 1e-3
MODES = ("stats", "full", "plain")

EXPERIMENT_YAML = """\
dataset: {{dataset_name: ho3d, image_size: [{img}, {img}]}}
network: {{enc_type: MHEnt, backbone: resnet18, num_latent: 32, h_dims: [32, 32],
          num_steps: 1}}
training: {{mode: baseline_VAE, epochs: 1, batch_size: 8, seed: 3, lr: 0.0001,
           test_samples: 4, n_train_hypotheses: 2}}
info_interval: 1
tpu: {{compute_dtype: float32}}
"""


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
    inputs.update(yaml=str(yaml), model_dir=str(tmp / "two_ranks"), mh_n=13, mh_batch=4)
    gcfg = inputs["cfg"]._replace(regressor="glow", glow_hidden=16, glow_layers=2)
    inputs["glow"] = {"cfg": gcfg, "state": mhent.init(gcfg, seed=2).state_dict()}
    # The group runs while this process makes the export artifact and
    # computes the 1-process references, in a thread beside JAX's step
    # (which compiles meanwhile) and on fewer threads to leave the group
    # cores.
    group = torch_dist.Group(2, ["dp", "dp_glow", "fsdp", "tp", "tp_draw", "eval", "export",
                                 "experiment", "multihost"], inputs)
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
                       "det_head.0.weight": np.asarray(new.params["det_head"]["l0"]["w"]).T}
            one = port.result()
    except BaseException:
        group.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    return inputs, jax_out, group.results(), one


def _port_side(group, inputs, tmp, yaml):
    """Sends the group the export artifact; returns the port's 1-process
    results."""
    group.send("export", torch_dist.export_blob(inputs, 2))
    one = {"dp": {m: torch_dist.train_once(inputs, bn_mode="stats" if m == "plain" else m,
                                           kernels=m != "plain") for m in MODES},
           "dp_glow": torch_dist.train_once(dict(inputs, **inputs["glow"])),
           "fsdp": torch_dist.train_once(inputs, steps=2),
           "eval": torch_dist.eval_once(inputs),
           "draw": torch_dist.draw_grads(inputs, fused=False)}
    cfg = load_cfg(str(yaml))
    cfg.model_dir = str(tmp / "one_rank")
    with Experiment(cfg, device="cpu") as exp:
        one["experiment"] = exp.train_baseline()
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
    _, _, results, one = setup
    got, want = results["fsdp"], one["fsdp"]
    assert _rel(got["aux"][0]["loss"], want["aux"][0]["loss"]) < 1e-4
    assert _rel(got["aux"][1]["loss"], want["aux"][1]["loss"]) < 1e-2
    np.testing.assert_allclose(got["state"]["det_head.0.weight"],
                               want["state"]["det_head.0.weight"], atol=1e-2)


def test_fsdp_shards_the_state(setup):
    """Every parameter of at least 4096 elements is split over the 2 data
    ranks, Adam's moments with it."""
    inputs, _, results, _ = setup
    net = mhent.MHEnt(inputs["cfg"])
    big = {k for k, p in net.named_parameters() if p.numel() >= 4096}
    numel = results["fsdp"]["shard_numel"]
    assert big and set(numel) == big
    for k, p in net.named_parameters():
        if k in big:
            assert numel[k] * 2 == p.numel(), k


def test_fsdp_checkpoint_restores_into_replicated_layout(setup):
    """The gathered weights and optimizer state load into a 1-process MHEnt
    and Optimizer bit-exactly (after two steps), and after the first step
    the gathered Adam moments are the 1-process run's, to 1e-4 of each
    tensor's largest entry (the gradient's tolerance)."""
    inputs, _, results, one = setup
    got = results["fsdp"]
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
    first, ref = got["opt_first"]["adam"]["state"], one["fsdp"]["opt_first"]["adam"]["state"]
    assert set(first) == set(ref) and ref
    for i, st in ref.items():
        for m in ("exp_avg", "exp_avg_sq"):
            _close_to_largest(first[i][m], st[m], 1e-4, (i, m))


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


def test_tp_f32_sampler_route_gradients_match_one_process(setup):
    """The train step's draw through the f32 sampler's autograd route
    (`TransformDiff`: whole forward, split recompute in the backward) under
    tp = 2 gives the 1-process plain draw's gradients, the replicated layer
    before the flow's included (its cotangent through the c.0 projections
    summed over 'model')."""
    _, _, results, one = setup
    got, want = results["tp_draw"], one["draw"]
    assert set(got) == set(want) and "layer.weight" in want
    for k, g in want.items():
        _close_to_largest(got[k], g, 1e-4, k)


@pytest.mark.parametrize("layout", ["hypo", "data", "tp"])
def test_sharded_eval_matches_one_process(setup, layout):
    _, _, results, one = setup
    got, want = results["eval"][layout], one["eval"]
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1.0), (k, got[k], v)


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
