"""Run the port's parallel paths in a gloo process group on the CPU.

`Group(world, cases, inputs)` starts `world` processes (one group, a free
localhost port) that run each named case (`case_<name>`) on every rank in
order; `results()` returns rank 0's (`run_group` does both at once). The cases import only torch and the
port, so the workers start without JAX; the test files compute the JAX and
1-process references in the parent and assert on what comes back.
"""

from __future__ import annotations

import copy
import os
import socket
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_THREADS = 1
# torch's intra-op threads while a port test module runs: the suite's
# workers run side by side on the machine's cores, and a worker each
# spinning up one thread a core oversubscribes them many times over.
TEST_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """TEST_THREADS torch threads for the module that imports this fixture
    (autouse), the process's count again after it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(TEST_THREADS)
    yield
    torch.set_num_threads(prev)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """`world` worker processes running `cases` on `inputs`, started on
    construction; `results()` waits for them (at most `timeout` seconds)
    and returns rank 0's results. The caller may compute in the meantime."""

    def __init__(self, world: int, cases: list, inputs: dict, timeout: float = 300.0):
        self.tmp = tempfile.TemporaryDirectory()
        self.world, self.timeout = world, timeout
        torch.save(inputs, os.path.join(self.tmp.name, "inputs.pt"))
        ctx = mp.get_context("spawn")
        port = free_port()
        self.procs = [ctx.Process(target=_worker, args=(r, world, port, self.tmp.name, cases))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def send(self, name: str, obj) -> None:
        """Hand the workers `obj` after the start; a case takes it with
        `receive(inputs, name)`, which waits for it."""
        path = os.path.join(self.tmp.name, f"{name}.pt")
        torch.save(obj, path + ".part")
        os.replace(path + ".part", path)

    def kill(self) -> None:
        """Stop the workers (the caller failed before `results`)."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        self.tmp.cleanup()

    def results(self) -> dict:
        tmp = self.tmp.name
        try:
            for p in self.procs:
                p.join(self.timeout)
            codes = [p.exitcode for p in self.procs]
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            errors = [open(os.path.join(tmp, f"error{r}.txt")).read() for r in range(self.world)
                      if os.path.exists(os.path.join(tmp, f"error{r}.txt"))]
            if errors or any(c != 0 for c in codes):
                raise RuntimeError(f"worker exit codes {codes}:\n" + "\n".join(errors))
            return torch.load(os.path.join(tmp, "out.pt"), weights_only=False)
        finally:
            self.tmp.cleanup()


def run_group(world: int, cases: list, inputs: dict, timeout: float = 300.0) -> dict:
    return Group(world, cases, inputs, timeout).results()


def receive(inputs: dict, name: str, timeout: float = 300.0):
    """What the parent sent as `name` (`Group.send`), once it is there."""
    path = os.path.join(inputs["_dir"], f"{name}.pt")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the parent sent no {name!r}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _worker(rank: int, world: int, port: int, tmp: str, cases: list) -> None:
    import traceback

    torch.set_num_threads(N_THREADS)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        inputs["_dir"] = tmp
        out = {}
        for name in cases:
            out[name] = globals()[f"case_{name}"](inputs)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - the rank's failure goes to the parent
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        os._exit(1)


# --- the model at tests/test_engine.py's small_cfg sizes ----------------------

def small_cfg(img: int = 32, n_train: int = 2, h: int = 32, steps: int = 1):
    from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
    from mhentropy_tpu_torch.models import mhent
    from mhentropy_tpu_torch.models.encoder import EncoderConfig

    return mhent.MHEntConfig(
        encoder=EncoderConfig(backbone="resnet18", n_latent=(32, 32), dtype="float32"),
        flow=RealNVPConfig(dim=45, cond_dim=32, h_dim=h, num_steps=steps),
        feat_dim=32, image_size=img, n_train_hypotheses=n_train)


def build(inputs: dict, train: bool):
    """The MHEnt of inputs["state"] at inputs["cfg"], prepared on the CPU."""
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.models import mhent

    cfg = inputs["cfg"]
    net = mhent.MHEnt(cfg)
    net.load_state_dict(inputs["state"], strict=True)
    net = mhent.prepare(net, "cpu", masters=train)
    net.set_kernels(inputs.get("kernels", True))
    net.feat_extractor.res.bn_mode = inputs.get("bn_mode", "stats")
    return mano.synthetic_mano_model(seed=0), net.train() if train else net


def batch(inputs: dict):
    return (torch.from_numpy(inputs["image"]),
            {k: torch.from_numpy(v) for k, v in inputs["target"].items()})


def train_once(inputs: dict, mesh=None, fsdp: bool = False, tp: bool = False, steps: int = 1,
               bn_mode: str = "stats", kernels: bool = True):
    """steps train steps from inputs["state"]: ([aux], state dict, global
    gradients and the optimizer's state_dict, all in the 1-process layout;
    with fsdp or tp, each split parameter's stored numel and its
    gradient's and Adam moments')."""
    from mhentropy_tpu_torch.parallel import sharded
    from mhentropy_tpu_torch.train import engine

    model, net = build(dict(inputs, bn_mode=bn_mode, kernels=kernels), train=True)
    if fsdp or tp:
        sharded.distribute(net, mesh, fsdp=fsdp, tp=tp)
    opt = engine.make_optimizer(net, inputs["lr"], [100], 10)
    step = engine.make_train_step(model, net, opt, mesh=mesh, tp=tp,
                                  generator=torch.Generator().manual_seed(17))
    image, target = batch(inputs)
    auxes, first = [], None
    for i in range(steps):
        aux = step(image, target, torch.from_numpy(inputs["noise"][i]))
        auxes.append({k: float(v) for k, v in aux.items()})
        if i == 0:
            first = copy.deepcopy(opt.state_dict())
    out = {"aux": auxes, "grads": sharded.gathered_grads(net), "opt": opt.state_dict(),
           "opt_first": first}
    if fsdp or tp:
        # A parameter without a gradient (the sigma head) has no moments.
        out["stored"] = {k: {"param": p.numel(), **({} if p.grad is None else {
            "grad": p.grad.numel(),
            **{m: opt.adam.state[p][m].numel() for m in ("exp_avg", "exp_avg_sq")}})}
            for k, p in net.named_parameters() if sharded.piece(p) is not None}
    out["state"] = {k: v.detach().clone() for k, v in net.state_dict().items()}
    return out


def eval_once(inputs: dict, mesh=None, tp: bool = False, n_quant=None) -> dict:
    from mhentropy_tpu_torch.parallel import sharded
    from mhentropy_tpu_torch.train import engine

    model, net = build(inputs, train=False)
    if tp:
        sharded.distribute(net, mesh, tp=True)
    step = engine.make_eval_step(model, net, inputs["n"], 0.8, n_quant=n_quant, mesh=mesh, tp=tp,
                                 generator=torch.Generator().manual_seed(19))
    image, target = batch(inputs)
    mets = step(image, target, torch.from_numpy(inputs["kld_noise"]),
                torch.from_numpy(inputs["hypo_noise"]))
    return {k: float(v) for k, v in mets.items()}


def draw_grads(inputs: dict, mesh=None, fused: bool = True) -> dict:
    """The reverse-KL draw of inputs["state"]'s flow, conditioned on
    features that a replicated layer makes (inputs["draw_feat"] through
    inputs["draw_w"], inputs["draw_b"]), through the f32 sampler's autograd
    route (`cuda_sampler.sample_fused_diff`: the kernel path's
    `TransformDiff`, whose transform is the plain one on the CPU) or the
    plain draw, inside `sharded.tensor_parallel(mesh)`. Returns the
    gradients of a loss of it, summed as the train step sums them."""
    from mhentropy_tpu_torch.flows import cuda_sampler, realnvp
    from mhentropy_tpu_torch.parallel import sharded

    _, net = build(inputs, train=True)
    if mesh is not None:
        sharded.distribute(net, mesh, tp=True)
    flow = net.q_z_giv_i
    w = torch.from_numpy(inputs["draw_w"])
    layer = torch.nn.Linear(w.shape[1], w.shape[0])
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(torch.from_numpy(inputs["draw_b"]))
    both = torch.nn.ModuleDict({"net": net, "layer": layer})
    both.zero_grad(set_to_none=True)
    n = inputs["cfg"].n_train_hypotheses
    noise = torch.from_numpy(inputs["noise"][0])
    with sharded.tensor_parallel(mesh):
        feat = layer(torch.from_numpy(inputs["draw_feat"]))
        if fused:
            x, lp = cuda_sampler.sample_fused_diff(flow, feat, n, noise)
        else:
            cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
            x, lp = realnvp.sample(flow, noise, cproj=cproj.repeat(1, 1, n, 1))
        ((x ** 2).sum() + lp.sum()).backward()
    if mesh is not None:
        sharded.sync_grads(both, mesh)
    return sharded.gathered_grads(both)


# --- the cases a group runs ----------------------------------------------------

def _mesh(**shape):
    from mhentropy_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(**shape)


def case_dp(inputs):
    mesh = _mesh()
    return {mode: train_once(inputs, mesh, bn_mode=mode if mode != "plain" else "stats",
                             kernels=mode != "plain")
            for mode in ("stats", "full", "plain")}


def case_dp_glow(inputs):
    """The glow regressor's step: its dropout masks drawn for the global
    batch (engine's `glow.global_rows`)."""
    return train_once(dict(inputs, **inputs["glow"]), _mesh())


def case_fsdp(inputs):
    """ZeRO-3 for two steps, and data parallelism beside it."""
    mesh = _mesh()
    return {"zero3": train_once(inputs, mesh, fsdp=True, steps=2),
            "dp": train_once(inputs, mesh, steps=2)}


def case_tp(inputs):
    return train_once(inputs, _mesh(tp=2), tp=True)


def case_glow_tp(inputs):
    """The glow regressor at tp = 2: one train step and the eval step."""
    glow = dict(inputs, **inputs["glow"])
    return {"train": train_once(glow, _mesh(tp=2), tp=True),
            "eval": eval_once(glow, _mesh(tp=2), tp=True)}


def glow_bn_once(inputs: dict, mesh=None) -> dict:
    """A Glow with BatchNorm in its coupling nets (inputs["glow_bn"]): the
    train-mode log-prob's gradients (dropout masks from a seeded
    generator) and one `bn_stats_update`, inside `sharded.tensor_parallel`
    of `mesh` with the split blocks stored split; the gradients and the
    state in the 1-process layout."""
    from mhentropy_tpu_torch.flows import glow
    from mhentropy_tpu_torch.parallel import sharded

    g = inputs["glow_bn"]
    flow = glow.ConditionalGlow(g["cfg"])
    flow.load_state_dict(g["state"])
    x, ctx = torch.from_numpy(g["x"]), torch.from_numpy(g["ctx"])
    if mesh is not None:
        sharded.distribute(flow, mesh, tp=True)
    with sharded.tensor_parallel(mesh):
        lp = glow.log_prob(flow, x, ctx, train=True, generator=torch.Generator().manual_seed(3))
        (-lp.sum()).backward()
        glow.bn_stats_update(flow, x, ctx)
    if mesh is not None:
        sharded.sync_grads(flow, mesh, sharded.partial_names(flow))
        sharded.sync_split_stats(flow, mesh)
    return {"log_p": lp.detach(), "grads": sharded.gathered_grads(flow),
            "state": {k: v.clone() for k, v in flow.state_dict().items()}}


def case_glow_bn_tp(inputs):
    return glow_bn_once(inputs, _mesh(tp=2))


def case_fsdp_tp(inputs):
    """ZeRO-3 over 'data' and tensor parallelism over 'model' at once (the
    2-D layout), on inputs["layout_inputs"]."""
    return train_once(inputs["layout_inputs"], _mesh(tp=2), fsdp=True, tp=True)


def rle_build(inputs: dict, train: bool):
    """The RLE of inputs["rle"] on the CPU (kernels off: the plain BN sums
    under the data-parallel statistics)."""
    from mhentropy_tpu_torch.models import rle

    r = inputs["rle"]
    net = rle.RLE(r["cfg"])
    rle.load_checkpoint(net, r["state"])
    return net.train(train)


def rle_once(inputs: dict, mesh=None) -> dict:
    """Two RLE train steps and one eval step from inputs["rle"]:
    ([aux], the first step's global gradients (clipped), state dict,
    metrics)."""
    from mhentropy_tpu_torch.parallel import sharded
    from mhentropy_tpu_torch.train import engine

    r = inputs["rle"]
    net = rle_build(inputs, True)
    opt = engine.make_optimizer(net, r["lr"], [1], steps_per_epoch=1)
    step = engine.make_rle_train_step(net, opt, mesh=mesh)
    image = torch.from_numpy(r["image"])
    target = {k: torch.from_numpy(v) for k, v in r["target"].items()}
    auxes, grads = [], None
    for noise, base in r["draws"]:
        aux = step(image, target, torch.from_numpy(noise), torch.from_numpy(base))
        auxes.append({k: float(v) for k, v in aux.items()})
        if grads is None:
            grads = {k: g.clone() for k, g in sharded.gathered_grads(net).items()}
    out = {"aux": auxes, "grads": grads,
           "state": {k: v.detach().clone() for k, v in net.state_dict().items()}}
    noise, base = r["eval_draws"]
    mets = engine.make_rle_eval_step(net.eval(), mesh=mesh)(
        image, target, torch.from_numpy(noise), torch.from_numpy(base))
    out["eval"] = {k: float(v) for k, v in mets.items()}
    return out


def case_rle(inputs):
    return rle_once(inputs, _mesh())


def case_experiments(inputs):
    """run.py's Experiment on the group for each YAML of
    inputs["experiments"] (glow at tp = 2, the RLE mode on 2 data ranks,
    hypotheses over 2 hypo ranks with a top-test_quant filter): the
    summaries of their last eval."""
    from mhentropy_tpu_torch.train.engine import Experiment
    from mhentropy_tpu_torch.utils.config import load_cfg

    out = {}
    for name, (yaml, model_dir) in inputs["experiments"].items():
        cfg = load_cfg(yaml)
        cfg.model_dir = model_dir
        with Experiment(cfg, device="cpu") as exp:
            out[name] = exp.train_baseline()
    return out


def draw_without_grads(inputs: dict, mesh) -> dict:
    """The draw of `draw_grads` with the flow stored split over 'model',
    inside `sharded.tensor_parallel(mesh)`: through the f32 sampler's route
    without gradients (the eval's reverse-KL term, on
    `cuda_sampler.packed_now`) twice, and under autograd; whether the
    second draw without gradients reused the first one's pack."""
    from mhentropy_tpu_torch.flows import cuda_sampler
    from mhentropy_tpu_torch.parallel import sharded

    _, net = build(inputs, train=True)
    sharded.distribute(net, mesh, tp=True)
    flow = net.q_z_giv_i
    w, b = torch.from_numpy(inputs["draw_w"]), torch.from_numpy(inputs["draw_b"])
    feat = torch.from_numpy(inputs["draw_feat"]) @ w.T + b
    n = inputs["cfg"].n_train_hypotheses
    noise = torch.from_numpy(inputs["noise"][0])
    with sharded.tensor_parallel(mesh):
        with torch.inference_mode():
            first = cuda_sampler.sample_fused_diff(flow, feat, n, noise)
            packed = cuda_sampler.packed_now(flow)
            again = cuda_sampler.sample_fused_diff(flow, feat, n, noise)
            reused = cuda_sampler.packed_now(flow) is packed
        grad = [t.detach() for t in cuda_sampler.sample_fused_diff(flow, feat, n, noise)]
    return {"no_grad": [t.clone() for t in first], "again": [t.clone() for t in again],
            "grad": grad, "reused": reused}


def case_tp_draw(inputs):
    """The f32 sampler's autograd route under tp = 2 (the kernel path of the
    train step's draw on the card), and its draw without gradients."""
    mesh = _mesh(tp=2)
    return {"grads": draw_grads(inputs, mesh), "no_grad": draw_without_grads(inputs, mesh)}


def case_eval(inputs):
    return {"hypo": eval_once(inputs, _mesh(hypo=2)), "data": eval_once(inputs, _mesh()),
            "tp": eval_once(inputs, _mesh(tp=2), tp=True),
            "hypo_quant": eval_once(inputs, _mesh(hypo=2), n_quant=inputs["n_quant"])}


def export_blob(inputs: dict, world: int) -> bytes:
    """export.py's artifact of the sampler for one of `world` ranks' share
    of the batch."""
    from mhentropy_tpu_torch import export

    model, net = build(inputs, train=False)
    return export.export_sampler(model, net, inputs["image"].shape[0] // world, n=inputs["n"],
                                 temp=0.8)


def case_export(inputs):
    """Every rank loads the same export.py artifact (`export_blob`, which
    the parent sends as "export") and serves its share of the batch
    (`export.ShardedSampler`). Returns the gathered outputs and the live
    unsharded call's."""
    from mhentropy_tpu_torch import export

    model, net = build(inputs, train=False)
    image, noise = torch.from_numpy(inputs["image"]), torch.from_numpy(inputs["hypo_noise"])
    served = export.ShardedSampler(receive(inputs, "export"), _mesh()).call(image, noise)
    with torch.no_grad():
        live = export.make_sample_fn(model, net, inputs["n"], 0.8)(image, noise)
    return {"served": {k: v.clone() for k, v in served.items()},
            "live": {k: v.clone() for k, v in live.items()}}


def case_experiment(inputs):
    """run.py's path on the group: the YAML at inputs["yaml"] trained and
    evaluated by the Experiment; returns its summary and the files each
    rank wrote."""
    from mhentropy_tpu_torch.train.engine import Experiment
    from mhentropy_tpu_torch.utils.config import load_cfg

    cfg = load_cfg(inputs["yaml"])
    cfg.model_dir = inputs["model_dir"]
    with Experiment(cfg, device="cpu") as exp:
        summary = exp.train_baseline()
    dist.barrier()
    return {"summary": summary, "files": sorted(os.listdir(inputs["model_dir"]))}


def case_load_model(inputs):
    """The Experiment of inputs["load"]["yaml"] (ZeRO-3 over the group's
    data ranks) with a .pth's det_head and q_z_giv_i restored through
    `load_model`, asked for before the state and applied by
    `_ensure_state`: its state in the 1-process layout, the count of
    parameters it stores split, and its models.txt."""
    from mhentropy_tpu_torch.parallel import sharded
    from mhentropy_tpu_torch.train.engine import Experiment
    from mhentropy_tpu_torch.utils.config import load_cfg

    ld = inputs["load"]
    cfg = load_cfg(ld["yaml"])
    cfg.model_dir = ld["model_dir"]
    with Experiment(cfg, device="cpu") as exp:
        exp.load_model(ld["pth"], mod_names=["det_head", "q_z_giv_i"])
        exp._ensure_state(4)
        split = sum(sharded.piece(p) is not None for p in exp.net.parameters())
        state = {k: v.detach().clone() for k, v in exp.net.state_dict().items()}
    dist.barrier()
    with open(os.path.join(ld["model_dir"], "models.txt")) as f:
        return {"state": state, "split": split, "models_txt": f.read()}


def case_multihost(inputs):
    from mhentropy_tpu_torch.data import synthetic
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.parallel import mesh as mesh_lib
    from mhentropy_tpu_torch.parallel import multihost

    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=inputs["mh_n"], image_size=16,
                                  seed=5)
    gathered = [(mesh_lib.all_gather(torch.as_tensor(np.asarray(img)), dist.group.WORLD),
                 mesh_lib.all_gather(torch.as_tensor(np.asarray(t["valid"])), dist.group.WORLD))
                for img, t in multihost.multihost_batches(data, inputs["mh_batch"])]
    # A rank's local batch (its rows in rank order) as its shard of the
    # global one, on a data mesh and on a hypo mesh.
    image, target = numpy_batch(4, 16, seed=6)
    rows = slice(2 * dist.get_rank(), 2 * dist.get_rank() + 2)
    local = (image[rows], {k: v[rows] for k, v in target.items()})
    full = (torch.from_numpy(image), {k: torch.from_numpy(v) for k, v in target.items()})
    same = {}
    for name, mesh in (("data", mesh_lib.make_mesh()), ("hypo", mesh_lib.make_mesh(hypo=2))):
        got = multihost.global_batch_from_local(mesh, local, global_batch_size=4)
        want = mesh_lib.shard_batch(mesh, full)
        eq = torch.equal(got[0], want[0]) and set(got[1]) == set(want[1]) and all(
            torch.equal(got[1][k], v) for k, v in want[1].items())
        same[name] = mesh_lib.all_gather(torch.tensor([eq]), dist.group.WORLD).tolist()
    return {"batches": gathered, "rank_indices": multihost.host_shard_indices(inputs["mh_n"]),
            "global_from_local": same}


def case_pipeline(inputs):
    """The pipelined forward, inverse, log-prob and sample on a pp mesh, with
    the gradients of a loss of each (summed over 'pipe' as the train step
    sums them)."""
    from mhentropy_tpu_torch.flows import realnvp
    from mhentropy_tpu_torch.parallel import pipeline, sharded

    mesh = _mesh(pp=dist.get_world_size())
    flow = realnvp.RealNVP(inputs["flow_cfg"])
    flow.load_state_dict(inputs["flow_state"])
    x = torch.from_numpy(inputs["x"])
    feat = torch.from_numpy(inputs["feat"])
    names = pipeline.stage_names(flow)
    out = {}

    def grads(loss):
        flow.zero_grad()
        loss.backward()
        pipeline.drain()
        sharded.sync_grads(flow, mesh, pipe_names=names)
        return {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                for k, p in flow.named_parameters()}

    with torch.no_grad():  # a constant of the loss, as in tests/test_pipeline.py
        cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
    z, ld = pipeline.inverse_pipelined(flow, x, cproj, mesh, inputs["n_micro"])
    out["inverse"] = (z.detach(), ld.detach())
    out["inverse_grads"] = grads((z ** 2).sum() + (ld ** 2).sum())
    cproj = realnvp.cond_cache(flow, realnvp.make_cond(flow, feat))
    xf, ldf = pipeline.forward_pipelined(flow, x, cproj, mesh, inputs["n_micro"])
    out["forward"] = (xf.detach(), ldf.detach())
    out["log_prob"] = pipeline.log_prob_pipelined(flow, x, feat, mesh,
                                                  inputs["n_micro"]).detach()
    s, lp = pipeline.sample_pipelined(flow, torch.from_numpy(inputs["z0"]), feat, mesh,
                                      inputs["n_micro"], return_log_prob=True)
    out["sample"] = (s.detach(), lp.detach())
    out["sample_grads"] = grads((s ** 2).sum() + (lp ** 2).sum())
    with torch.no_grad():
        s2 = pipeline.sample_pipelined(flow, torch.from_numpy(inputs["z0"]), feat, mesh,
                                       inputs["n_micro"])
    out["sample_no_grad"] = s2
    return out


def case_pipe_step(inputs):
    """One train step with the draw through the GPipe schedule (pp = world
    size), on inputs["pipe_inputs"]."""
    from mhentropy_tpu_torch.train import engine

    inp = inputs["pipe_inputs"]
    mesh = _mesh(pp=dist.get_world_size())
    model, net = build(inp, train=True)
    opt = engine.make_optimizer(net, inp["lr"], [100], 10)
    step = engine.make_train_step(model, net, opt, mesh=mesh, pipe=True, n_micro=2)
    image, target = batch(inp)
    aux = step(image, target, torch.from_numpy(inp["noise"][0]))
    return {"aux": [{k: float(v) for k, v in aux.items()}],
            "grads": {k: p.grad.clone() for k, p in net.named_parameters()
                      if p.grad is not None}}


def numpy_batch(n: int = 8, img: int = 32, seed: int = 1):
    """A synthetic batch of the port's fixture (numpy image and target)."""
    from mhentropy_tpu_torch.core import mano
    from mhentropy_tpu_torch.data import synthetic

    data = synthetic.make_dataset(mano.synthetic_mano_model(0), n=n, image_size=img, seed=seed)
    return (np.ascontiguousarray(data.images[:n]),
            {k: np.ascontiguousarray(v[:n]) for k, v in data.targets.items()})

