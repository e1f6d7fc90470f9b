"""Model assembly from the YAML schema, the MANO asset loader, the training
step and the multi-hypothesis eval step, and the experiment loop around them.

Port of mhentropy_tpu/train/engine.py: `_fused_bn_mode` :54,
`build_model_config` :63, `load_mano_model` :330 (with `_mano_fingerprint`
:308), `_prep_image` :197, `_prep_batch` :225, `make_optimizer` :338 with
the TrainState :47 / `init_state` :349 it sits in (a module, an optimizer
and a step count here), `make_train_step` :359, `make_eval_step` :426, and
`_num_samples` :304, of `Experiment` its sinks (`info_<mode>.log` and
`scalars.jsonl` in model_dir, :539-545, with `close` :567, the context
manager and the finaliser, `_close_sinks` :1096 and `close_all_experiments`
:1110), `make_datasets` :587 (the RHD, FreiHAND, HO3D and mixed loaders
from tpu.data_dir, the synthetic fixture without one), `_get_optimizer`
:692, `_ensure_state` :718, `_latest_checkpoint` :822, `train_baseline`
:841 (with tpu.autoresume), `train_epoch` :876, `_quant_spec` :921,
`eval_loop` :950, `eval` :1016 and `save_model` :1043; and the
non-integrated RLE mode that a `network.enc_type` other than "MHEnt"
selects (:505-518): `build_rle_config` :115, `make_rle_train_step` :249
and `make_rle_eval_step` :280, with `Experiment`'s branches for it
(checkpoints in the reference's RLE schema, {'encoderRGB', 'p_nf'}).
Checkpoints are the reference's .pth (its `mano_dec.*` buffers dropped by
`convert.load_reference_state`); an orbax directory of the JAX package is
converted to one by the repository's `orbax_to_pth.py` (orbax imports JAX,
which the port does not).

Both loops feed their steps through `data.common.prefetch` over
`data.common.batches(..., device=)`: a thread builds each batch and copies
it to the device while the step before it runs.

The steps are plain functions of their batch and noise: torch cannot replay
jax.random, so the reverse-KL draw's noise (temperature 1), the eval
hypotheses' noise (times temp) and the RLE step's two draws come from the
caller, as the JAX steps split their keys into independent streams; the
glow regressor's dropout masks come from the generator the step is built
with.
"""

from __future__ import annotations

import logging
import math
import os
import re
import time
import weakref

import torch

from mhentropy_tpu_torch import convert
from mhentropy_tpu_torch.core import camera
from mhentropy_tpu_torch.core import mano as mano_lib
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel
from mhentropy_tpu_torch.data import common as data_common
from mhentropy_tpu_torch.data import synthetic
from mhentropy_tpu_torch.flows import glow
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import bn_cuda, mhent, rle
from mhentropy_tpu_torch.models import quant as quant_mod
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.models.mhent import MHEntConfig
from mhentropy_tpu_torch.models.rle import RLEConfig
from mhentropy_tpu_torch.parallel import mesh as mesh_lib
from mhentropy_tpu_torch.parallel import pipeline as pipe_lib
from mhentropy_tpu_torch.parallel import sharded
from mhentropy_tpu_torch.parallel.mesh import DATA_AXIS, HYPO_AXIS, PIPE_AXIS
from mhentropy_tpu_torch.train import metrics as metrics_lib
from mhentropy_tpu_torch.utils.logging import AverageMeter, ScalarWriter, get_logger


def _fused_bn_mode(cfg):
    """cfg.tpu.fused_train_bn -> False | True | mode string (bool() would
    collapse "full" to True)."""
    v = cfg.tpu.fused_train_bn
    return v if isinstance(v, str) else bool(v)


def build_model_config(cfg) -> MHEntConfig:
    """YAML schema -> MHEntConfig."""
    net = cfg.network
    enc = _encoder_config(cfg)
    flow = RealNVPConfig(
        dim=45,
        cond_dim=net.num_latent,
        h_dim=net.h_dims[0],
        num_steps=net.num_steps,
        joint_n=cfg.dataset.jointN,
    )
    return MHEntConfig(
        encoder=enc,
        flow=flow,
        mano=ManoConfig(use_pca=True, ncomps=45, flat_hand_mean=False),
        regressor=net.regressor,
        ds=cfg.dataset.dataset_name,
        image_size=max(cfg.dataset.image_size),
        feat_dim=net.num_latent,
        b_2d=net.b_2d,
        b_3d=net.b_3d,
        th45_ref_alpha=float(net.w_reg_th),
        th3_ref_alpha=float(net.th3_ref_alpha),
        bt_alpha=float(net.bt_alpha),
        temperature=float(net.T),
        entropy=bool(net.entropy),
        kld_w=float(net.kld_w),
        kld_w_annealing=tuple(net.kld_w_annealing),
        n_train_hypotheses=int(cfg.training.n_train_hypotheses),
        glow_hidden=int(net.glow_hidden),
        glow_layers=int(net.glow_layers),
        glow_blocks=int(net.glow_blocks),
        use_chamfer_loss=bool(net.use_chamfer_loss),
        w_chamfer=float(net.w_chamfer),
        use_mask_loss=bool(net.use_mask_loss),
        b_mask=float(net.b_mask),
    )


def _encoder_config(cfg) -> EncoderConfig:
    net = cfg.network
    n_latent = net.nums_latent if net.nums_latent else net.num_latent
    return EncoderConfig(
        backbone=net.backbone,
        n_latent=(n_latent, n_latent) if isinstance(n_latent, int) else tuple(n_latent),
        feat_dim=net.feat_dim,
        sigma_act=net.acts,
        deterministic=net.deterministic,
        dtype=cfg.tpu.compute_dtype,
        fused_train_bn=_fused_bn_mode(cfg),
    )


def build_rle_config(cfg) -> RLEConfig:
    """YAML schema -> RLEConfig for the non-integrated BasicEnc + p_nf mode:
    a per-joint flow of dim network.p_nf_dim, unconditional with the
    actnorm of a string tsfm_on ('x' / 'z'), conditioned on an integer
    tsfm_on's width otherwise."""
    net = cfg.network
    tsfm_on = net.tsfm_on
    flow = RealNVPConfig(
        dim=net.p_nf_dim,
        cond_dim=tsfm_on if isinstance(tsfm_on, int) else 0,
        h_dim=net.h_dims[0],
        num_steps=net.num_steps,
        joint_n=cfg.dataset.jointN,
        kemb=bool(net.kemb),
        tsfm_on=tsfm_on if isinstance(tsfm_on, str) else None,
        cond_mapping_dims=tuple(tuple(x) for x in (net.cond_mapping_dims or ())),
    )
    return RLEConfig(encoder=_encoder_config(cfg), flow=flow, pe=cfg.dataset.pe,
                     nf_res=net.nf_res, image_size=max(cfg.dataset.image_size))


def mano_fingerprint(mano_dir: str):
    """(abspath, mtime_ns, size) of the resolved MANO asset, or None for the
    synthetic stand-in."""
    path = mano_lib.find_mano_assets(mano_dir)
    if not path:
        return None
    path = os.path.abspath(path)
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


def load_mano_model(mano_dir: str = "./mano/", device="cpu") -> ManoModel:
    """MANO_RIGHT.pkl from `mano_dir`, or the synthetic stand-in (seed 0)
    when there is none."""
    fp = mano_fingerprint(mano_dir)
    if fp:
        return mano_lib.load_mano_pkl(fp[0], device=device)
    return mano_lib.synthetic_mano_model(seed=0, device=device)


def resolve_device(device) -> torch.device:
    """The card unless the caller asks for another device; no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this runs on the card by default; pass "
                           "device='cpu' (or --device cpu) to run on the CPU")
    return dev


def _prep_image(image: torch.Tensor, target: dict) -> torch.Tensor:
    """uint8 batches carry raw pixels and per-sample `_img_scale` /
    `_img_bias` affines (x / 255 without them); float batches pass."""
    if image.dtype != torch.uint8:
        return image
    img = image.float()
    pn = target.get("_pixel_noise")
    if pn is not None:
        img = torch.clamp(img * pn[:, None, None, :], 0.0, 255.0)
    scale = target.get("_img_scale")
    if scale is None:
        return img / 255.0
    return img * scale[:, None, None, None] + target["_img_bias"][:, None, None, None]


def _prep_target(target: dict) -> dict:
    """The orthographic camera `st` fitted from pose3d and crop_uv when the
    loader left it out."""
    if "st" not in target and "pose3d" in target and "crop_uv" in target:
        target = dict(target)
        uv = target["crop_uv"]
        k = uv.shape[-1] // 2
        target["st"] = camera.compute_st(target["pose3d"].reshape(-1, k, 3),
                                         uv.reshape(-1, k, 2))
    return target


def _prep_batch(image: torch.Tensor, target: dict):
    """Image normalisation plus the orthographic camera `st` fitted from
    pose3d and crop_uv when the loader left it out."""
    return _prep_image(image, target), _prep_target(target)


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), adam(piecewise_constant))
    of the JAX `make_optimizer`, over every parameter of `params`, with
    torch.optim.Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8).

    The clip is optax's exactly: g if |g| < max_norm else g / |g| * max_norm
    with |g| the global norm over all gradients (no +1e-6, unlike
    torch.nn.utils.clip_grad_norm_). Update k, counted from 0, runs at
    lr * gamma ** (number of milestones m with k >= m * steps_per_epoch).
    A parameter without a gradient (the sigma head, which no loss reads)
    is skipped: its optax moments and update stay 0 as well.

    It steps a net as `parallel.sharded.distribute` stored it: a split
    parameter's gradient and Adam moments take its shape, so they are its
    block as well (tpu.fsdp's ZeRO-3, as JAX's `make_train_step(fsdp=True)`
    :359-422; tp's 'model' blocks; both, the 2-D layout), and the clip's
    norm sums the blocks' squares over their ranks. `state_dict` gathers
    the moments into the 1-process layout, so a checkpoint restores into an
    unsharded run, and `load_state_dict` takes that layout.
    """

    def __init__(self, params, lr: float, milestones, steps_per_epoch: int,
                 gamma: float = 0.1, max_norm: float = 1.0):
        self.params = list(params)
        self.lr = float(lr)
        self.boundaries = sorted(int(m) * int(steps_per_epoch) for m in milestones)
        self.gamma = gamma
        self.max_norm = max_norm
        self.count = 0  # updates taken; the schedule reads it
        self.adam = torch.optim.Adam(self.params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def lr_at(self, k: int) -> float:
        return self.lr * self.gamma ** sum(k >= b for b in self.boundaries)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def global_norm(self) -> torch.Tensor:
        """The norm of every gradient together, the clip's (in the 1-process
        layout: a split parameter's block is summed over its ranks)."""
        return sharded.global_norm(self.params)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = self.global_norm()
        # Stays on the device: no host sync for the clip decision.
        divisor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                              norm / self.max_norm)
        torch._foreach_div_(grads, divisor)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1

    @torch.no_grad()
    def state_dict(self) -> dict:
        """{"count", "adam"}, the moments in the 1-process layout (a split
        parameter's gathered: collective then)."""
        adam = self.adam.state_dict()
        split = [(i, p) for i, p in enumerate(self.params)
                 if sharded.piece(p) is not None and i in adam["state"]]
        moments = ("exp_avg", "exp_avg_sq")
        whole = sharded.to_whole([p for _, p in split for _ in moments],
                                 [adam["state"][i][m] for i, _ in split for m in moments])
        for j, (i, _) in enumerate(split):
            adam["state"][i] = {**adam["state"][i],
                                **dict(zip(moments, whole[2 * j:2 * j + 2]))}
        return {"count": self.count, "adam": adam}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """`state_dict`'s layout; a split parameter takes its block."""
        adam = dict(state["adam"])
        adam["state"] = {i: {k: sharded.to_block(self.params[i], v)
                             if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()}
                         for i, st in state["adam"]["state"].items()}
        self.adam.load_state_dict(adam)
        self.count = int(state["count"])

    @torch.no_grad()
    def load_moments(self, named_params: dict, state: dict) -> None:
        """Adam moments by parameter name ({"count", "state": {name:
        {"exp_avg", "exp_avg_sq"}}}, as `convert.opt_state_from_jax` gives
        them), so a JAX-trained optimizer state continues here."""
        by_id = {id(p): name for name, p in named_params.items()}
        count = int(state["count"])
        for p in self.params:
            moments = state["state"].get(by_id[id(p)])
            if moments is None:
                continue
            self.adam.state[p] = {
                "step": torch.tensor(float(count)),
                **{m: torch.empty_like(p).copy_(sharded.to_block(p, moments[m]))
                   for m in ("exp_avg", "exp_avg_sq")}}
        self.count = count


def make_optimizer(net: torch.nn.Module, lr: float, milestones, steps_per_epoch: int,
                   gamma: float = 0.1) -> Optimizer:
    """Adam + MultiStep LR (gamma 0.1) + global-norm clip 1.0 over every
    parameter of `net` (CrossModalHand.py:201-203, 462-467)."""
    return Optimizer(net.parameters(), lr, milestones, steps_per_epoch, gamma=gamma)


def make_train_step(model: ManoModel, net: mhent.MHEnt, optimizer: Optimizer,
                    fold: mano_lib.KeypointFold | None = None,
                    generator: torch.Generator | None = None,
                    mesh: mesh_lib.Mesh | None = None, tp: bool = False, pipe: bool = False,
                    n_micro: int = 2):
    """One optimisation step of the reverse-KL objective.

    Returns step_fn(image, target, noise) -> aux {loss, th_norm, bt_norm,
    h_q, q_log_p} as 0-d tensors on the device (nothing is read on the
    host). noise: (n_train_hypotheses * B, 45) standard normal, the
    reverse-KL draw's base noise. The net must be in train mode: its BN
    running statistics are updated in place and its parameters by the
    optimizer. A padded tail batch (target["valid"]) is masked out of the
    loss. generator: the glow regressor's dropout masks.

    mesh: a `parallel.mesh.Mesh` of more than one rank (JAX's sharded step,
    :359-422). image, target and noise are then the global batch and its
    whole base noise, drawn alike on every rank, as the 1-process step
    takes them; each rank computes its 'data' rows (and their noise rows),
    train-mode BN takes the global batch's statistics, the glow regressor's
    dropout masks are the global batch's (`glow.global_rows`), a rank's
    loss is its share of the global batch's, the gradients are summed over the ranks
    (`sharded.sync_grads`), so that the optimizer steps on the global
    gradient on every rank: the step of the 1-process run on the global
    batch. The step runs the net as its builder stored it
    (`sharded.distribute`; `sharded.layout(net)`): tpu.fsdp's 'data' blocks
    are gathered for the forward and backward and keep their part of the
    summed gradients (`sharded.compute`, `sharded.sync_grads`); tp's
    'model' blocks compute the Megatron split over 'model'
    (`sharded.tensor_parallel`). tp=True asks for that split, and raises
    for a net not stored split over 'model'. pipe:
    the draw through the GPipe schedule over 'pipe' in n_micro microbatches
    (realnvp regressor only). The aux values are the global batch's.
    """
    if fold is None:
        fold = mano_lib.fold_keypoints(model)
    if mesh is not None and mesh.size > 1:
        return _sharded_train_step(model, net, optimizer, fold, generator, mesh, tp, pipe,
                                   n_micro)

    def step_fn(image, target, noise):
        image, target = _prep_batch(image, target)
        out = mhent.reverse_kld(model, net, target, image, base_noise=noise, train=True,
                                generator=generator, fold=fold)
        loss = _masked_loss(out["log_p"], target)  # criteria.py:55,173
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        h_q = out.get("h_q_z_giv_i")
        return {"loss": loss.detach(),
                "th_norm": out["th_norm"].detach().mean(),
                "bt_norm": out["bt_norm"].detach().mean(),
                "h_q": h_q.detach().mean() if h_q is not None else loss.new_zeros(()),
                "q_log_p": out["q_log_p_z_giv_y"].detach().mean()}

    return step_fn


def _split_tp(net: torch.nn.Module, tp: bool) -> bool:
    """Whether the net is stored split over 'model' (`sharded.distribute`);
    tp asks for it, and raises if it is not."""
    lay = sharded.layout(net)
    split = lay is not None and lay.tp
    if tp and not split:
        raise ValueError("tp: the net is not stored split over 'model'; call "
                         "sharded.distribute(net, mesh, tp=True) where it is built")
    return split


def _sharded_train_step(model, net, optimizer, fold, generator, mesh, tp, pipe, n_micro):
    tp = _split_tp(net, tp)
    partial = sharded.partial_names(net)
    pipeline = (mesh, n_micro) if pipe and mesh.shape[PIPE_AXIS] > 1 else None
    pipe_names = pipe_lib.stage_names(net) if pipeline is not None else set()
    group = mesh.group(DATA_AXIS)
    n_train = net.cfg.n_train_hypotheses

    def step_fn(image, target, noise):
        b = image.shape[0]
        image, target = mesh_lib.shard_batch(mesh, (image, target))
        noise = mesh_lib.shard_rows(mesh, noise, n_train, b, hypo=False)
        image, target = _prep_batch(image, target)
        optimizer.zero_grad()
        with sharded.compute(net), bn_cuda.global_batch(group), \
                sharded.tensor_parallel(mesh if tp else None), \
                glow.global_rows(n_train, b, mesh_lib.batch_sharding(mesh, b)):
            out = mhent.reverse_kld(model, net, target, image, base_noise=noise, train=True,
                                    generator=generator, fold=fold, pipeline=pipeline)
            loss = _global_loss(out["log_p"], target, b, group)
            loss.backward()
            if pipeline is not None:
                pipe_lib.drain()
            sharded.sync_grads(net, mesh, partial, pipe_names)
        optimizer.step()
        if tp:
            sharded.sync_split_stats(net, mesh)
        h_q = out.get("h_q_z_giv_i")
        sums = torch.stack([loss.detach(), out["th_norm"].detach().sum() / (n_train * b),
                            out["bt_norm"].detach().sum() / (n_train * b),
                            h_q.detach().sum() / b if h_q is not None else loss.new_zeros(()),
                            out["q_log_p_z_giv_y"].detach().sum() / b])
        sums = mesh_lib.all_reduce_(sums, group)
        return dict(zip(("loss", "th_norm", "bt_norm", "h_q", "q_log_p"), sums.unbind()))

    return step_fn


def _global_loss(lp: torch.Tensor, target: dict, b: int, group) -> torch.Tensor:
    """This rank's share of the global batch's -mean log p (a padded tail
    batch's padding masked out over the global valid count): summed over
    the ranks, the 1-process loss."""
    if "valid" in target:
        v = target["valid"]
        den = mesh_lib.all_reduce_(v.sum().detach(), group) + 1e-16
        return -(lp * v).sum() / den
    return -lp.sum() / b


def make_eval_step(model: ManoModel, net: mhent.MHEnt, n: int, temp: float,
                   n_quant: int | None = None, quant_spec=None,
                   fold: mano_lib.KeypointFold | None = None,
                   generator: torch.Generator | None = None,
                   mesh: mesh_lib.Mesh | None = None, tp: bool = False):
    """The multi-hypothesis eval step: reverse-KL log p with its entropy
    term, n hypotheses per image (int8 encoder and sampler when quant_spec
    is given), and the BH / WH / diversity metrics.

    Returns eval_fn(image, target, kld_noise, hypo_noise, qtree=None) ->
    {metric: 0-d tensor}; kld_noise (n_train_hypotheses * B, 45) is standard
    normal, hypo_noise (n * B, 45) is already times temp. The hypotheses are
    drawn with mods ("xyz", "uv"): the metrics never read the mesh.
    generator: the dropout masks of the glow regressor's reverse-KL draw,
    which runs in train mode here too, as in JAX.

    mesh: a `parallel.mesh.Mesh` of more than one rank (JAX :427-484). The
    step takes the global batch and its whole noise, as the 1-process step
    does; each rank encodes its 'data' rows and draws its share of the n
    hypotheses (`hypo_batch_spec`: N over 'hypo') through the kernels. BH,
    WH and diversity need every hypothesis, so the samples are gathered
    over 'hypo' and 'data' (and log p over 'data') and every rank scores
    the global batch: the metrics are the 1-process step's on every rank.
    With hypotheses split, a top-n_quant filter gathers each rank's log q
    with its hypotheses over 'hypo' and keeps the n_quant most likely of all
    n, as one process does. The net evaluates in place, as its builder
    stored it (`sharded.distribute`): its 'data' blocks gathered for the
    call (`sharded.compute`), its 'model' blocks computing the Megatron
    split over 'model'; the kernels read whole weights (`sharded.whole`).
    tp=True asks for that split, and raises for a net not stored split.
    """
    if fold is None:
        fold = mano_lib.fold_keypoints(model)
    if mesh is not None and mesh.size > 1:
        return _sharded_eval_step(model, net, n, temp, n_quant, quant_spec, fold, generator,
                                  mesh, tp)

    @torch.inference_mode()
    def eval_fn(image, target, kld_noise, hypo_noise, qtree=None):
        image, target = _prep_batch(image, target)
        # One float encoder pass feeds both terms; the int8 draw runs its
        # own int8 encoder, and the reverse-KL term keeps the float feature.
        feat = mhent.extract_feat(net, image)
        out = mhent.reverse_kld(model, net, target, image, base_noise=kld_noise,
                                generator=generator, fold=fold, feat=feat)
        samples = mhent.sample_hypotheses(
            model, net, image, n=n, n_quant=n_quant if n_quant is not None else n, temp=temp,
            mods=("xyz", "uv"), base_noise=hypo_noise, fold=fold,
            quant=(quant_spec, qtree) if quant_spec is not None else None,
            feat=feat if quant_spec is None else None)
        output = dict(samples)
        output["log_p"] = out["log_p"]
        total, _, mets = metrics_lib.mhent_metrics(output, target,
                                                   image_size=net.cfg.image_size)
        mets = {k: v.mean() for k, v in mets.items()}
        mets["loss_total"] = total
        return mets

    return eval_fn


def _sharded_eval_step(model, net, n, temp, n_quant, quant_spec, fold, generator, mesh, tp):
    n_quant = n if n_quant is None else n_quant
    tp = _split_tp(net, tp)
    n_hypo = mesh.shape[HYPO_AXIS]
    gather_q = n_quant < n and n_hypo > 1
    hypo_group, data_group = mesh.group(HYPO_AXIS), mesh.group(DATA_AXIS)
    n_train = net.cfg.n_train_hypotheses

    @torch.inference_mode()
    def eval_fn(image, target, kld_noise, hypo_noise, qtree=None):
        b = image.shape[0]
        full_target = _prep_target(target)
        image, target = _prep_batch(*mesh_lib.shard_batch(mesh, (image, target)))
        n_mine = n // n_hypo
        with sharded.compute(net), sharded.tensor_parallel(mesh if tp else None), \
                glow.global_rows(n_train, b, mesh_lib.batch_sharding(mesh, b)):
            feat = mhent.extract_feat(net, image)
            out = mhent.reverse_kld(model, net, target, image,
                                    base_noise=mesh_lib.shard_rows(mesh, kld_noise, n_train, b,
                                                                   hypo=False),
                                    generator=generator, fold=fold, feat=feat)
            samples = mhent.sample_hypotheses(
                model, net, image, n=n_mine, n_quant=None if gather_q else min(n_quant, n_mine),
                temp=temp, mods=("xyz", "uv"),
                base_noise=mesh_lib.shard_rows(mesh, hypo_noise, n, b), fold=fold,
                quant=(quant_spec, qtree) if quant_spec is not None else None,
                feat=feat if quant_spec is None else None, keep_log_q=gather_q)
        keys = ("xyz", "uv", "log_q") if gather_q else ("xyz", "uv")
        output = dict(zip(keys, mesh_lib.all_gather_many([samples[k] for k in keys], hypo_group,
                                                         [0] * len(keys))))
        if gather_q:
            # The n_quant most likely of all n hypotheses of each image, as
            # sample_hypotheses keeps them in one process.
            idx = torch.topk(output.pop("log_q").T, n_quant).indices.T[:, :, None]
            output = {k: torch.take_along_dim(v, idx, dim=0) for k, v in output.items()}
        output = {k: mesh_lib.all_gather(v, data_group, dim=1) for k, v in output.items()}
        output["log_p"] = mesh_lib.all_gather(out["log_p"], data_group, dim=0)
        total, _, mets = metrics_lib.mhent_metrics(output, full_target,
                                                   image_size=net.cfg.image_size)
        mets = {k: v.mean() for k, v in mets.items()}
        mets["loss_total"] = total
        return mets

    return eval_fn


def _masked_loss(lp: torch.Tensor, target: dict) -> torch.Tensor:
    """-mean log p, a padded tail batch's padding (target["valid"]) masked out."""
    if "valid" in target:
        v = target["valid"]
        return -(lp * v).sum() / (v.sum() + 1e-16)
    return -lp.mean()


def make_rle_train_step(net: rle.RLE, optimizer: Optimizer, mesh: mesh_lib.Mesh | None = None):
    """One optimisation step of the RLE density loss -log p.

    Returns step_fn(image, target, noise, base_noise) -> aux {loss, sigma_i}
    as 0-d tensors on the device; noise and base_noise as
    `rle.loss_and_predict` takes them. The net must be in train mode.

    mesh: a `parallel.mesh.Mesh` of more than one rank (JAX's
    `make_rle_train_step(..., mesh)`, :249-277): the step takes the global
    batch and its whole draws, alike on every rank; each rank computes its
    'data' rows, train-mode BN takes the global batch's statistics (the
    BN-sum kernel's sums all-reduced, `bn_cuda.global_batch`), a rank's
    loss is its share of the global valid-masked mean, and the gradients
    are summed over 'data' before the optimizer steps: the 1-process step
    on the global batch, its aux the global batch's.
    """
    if mesh is not None and mesh.size > 1:
        return _sharded_rle_train_step(net, optimizer, mesh)

    def step_fn(image, target, noise, base_noise):
        image, target = _prep_batch(image, target)
        out = rle.loss_and_predict(net, image, target, noise=noise, base_noise=base_noise,
                                   train=True)
        loss = _masked_loss(out["log_p"], target)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "sigma_i": out["sigma_i"]}

    return step_fn


def _rle_shard(mesh, net, image, target, noise, base_noise):
    """This rank's 'data' rows of an RLE batch and of its two draws."""
    b = image.shape[0]
    rows = mesh_lib.batch_sharding(mesh, b)
    k1, d = net.cfg.k1, net.cfg.flow.dim
    base = base_noise.reshape(k1, b, -1, d)[:, rows].reshape(k1, -1, d)
    image, target = _prep_batch(*mesh_lib.shard_batch(mesh, (image, target)))
    return image, target, noise[rows], base


def _sharded_rle_train_step(net, optimizer, mesh):
    group = mesh.group(DATA_AXIS)

    def step_fn(image, target, noise, base_noise):
        b = image.shape[0]
        image, target, noise, base_noise = _rle_shard(mesh, net, image, target, noise,
                                                      base_noise)
        optimizer.zero_grad()
        with bn_cuda.global_batch(group):
            out = rle.loss_and_predict(net, image, target, noise=noise, base_noise=base_noise,
                                       train=True)
            loss = _global_loss(out["log_p"], target, b, group)
            loss.backward()
        sharded.sync_grads(net, mesh)
        optimizer.step()
        # sigma_i is a mean over the rows: each rank's weighted by its rows.
        sums = torch.stack([loss.detach(), out["sigma_i"] * image.shape[0] / b])
        return dict(zip(("loss", "sigma_i"), mesh_lib.all_reduce_(sums, group).unbind()))

    return step_fn


def make_rle_eval_step(net: rle.RLE, mesh: mesh_lib.Mesh | None = None):
    """The RLE eval step: log p and the K1 draws scored by the BH / WH /
    diversity metrics, plus loss_total and sigma_i.

    Returns eval_fn(image, target, noise, base_noise) -> {metric: 0-d tensor}.
    mesh: a `parallel.mesh.Mesh` of more than one rank (JAX's
    `make_rle_eval_step(..., mesh)`, :280-301): each rank runs its 'data'
    rows of the global batch; log p and the draws are gathered over 'data'
    and every rank scores the global batch, sigma_i the global batch's.
    """
    sharded_mesh = mesh if mesh is not None and mesh.size > 1 else None
    group = mesh.group(DATA_AXIS) if sharded_mesh is not None else None

    @torch.inference_mode()
    def eval_fn(image, target, noise, base_noise):
        b = image.shape[0]
        full_target = _prep_target(target)
        if sharded_mesh is None:
            image, target = _prep_batch(image, target)
        else:
            image, target, noise, base_noise = _rle_shard(sharded_mesh, net, image, target,
                                                          noise, base_noise)
        out = rle.loss_and_predict(net, image, target, noise=noise, base_noise=base_noise)
        output = {"log_p": mesh_lib.all_gather(out["log_p"], group, dim=0)}
        for k in ("xyz", "uv"):
            if k in out:
                output[k] = mesh_lib.all_gather(out[k].reshape(*out[k].shape[:2], -1), group,
                                                dim=1)
        total, _, mets = metrics_lib.mhent_metrics(output, full_target,
                                                   image_size=net.cfg.image_size)
        mets = {k: v.mean() for k, v in mets.items()}
        mets["loss_total"] = total
        mets["sigma_i"] = mesh_lib.all_reduce_(out["sigma_i"] * image.shape[0] / b, group)
        return mets

    return eval_fn


def _num_samples(data) -> int:
    return data.images.shape[0] if hasattr(data, "images") else len(data)


class Experiment:
    """The JAX Experiment: config -> MANO, fresh or restored weights on the
    device, the datasets (tpu.data_dir's loaders, else the synthetic
    fixture), the train loop and the eval loop.

    network.enc_type "MHEnt" builds the integrated MHEnt; any other value
    the non-integrated RLE mode (BasicEnc + the network.p_nf flow,
    `models/rle.py`), as the JAX Experiment does.

    device: the card unless the caller passes another one (e.g. "cpu").
    With training.epochs > 0 the backbone keeps f32 master parameters and
    computes in tpu.compute_dtype; the eval kernels' weights are folded and
    packed again from them before each eval.

    It owns a file logger (`model_dir/info_<training.mode>.log`, also on
    stdout) and a ScalarWriter (`model_dir/scalars.jsonl`: the train loss
    as `loss_avg/loss_total` at each logged step, every eval metric as
    `metric_eval/<name>`, against the train step count). close() (or a
    `with` block) releases them; a finaliser does so when the instance is
    collected, and close_all_experiments() for every live one.

    In a process group (`parallel.multihost.initialize`, e.g. under
    `python -m torch.distributed.run`), or with tpu.mesh_hypo, tp or pp
    above 1, it lays the ranks out as JAX's Experiment lays out its devices
    (:527-536: `fit_devices` on the batch, then `make_mesh`), reads
    tpu.fsdp, and runs the sharded train and eval steps on it: every rank
    iterates the same global batches and draws the same noise (one seed),
    and computes its share of each step. An MHEnt is stored split at
    construction (`sharded.distribute`: tpu.fsdp's ZeRO-3 over 'data', tp's
    blocks over 'model', the glow regressor's blocks too); the RLE mode is
    data-parallel. Checkpoints hold the 1-process layout. Rank 0 alone
    writes the log, the scalars and the checkpoints.
    """

    _live: "weakref.WeakSet" = None  # initialised below the class

    def __init__(self, cfg, device=None, mano_dir: str = "./mano/"):
        self.cfg = cfg
        self.integrated = cfg.network.enc_type == "MHEnt"
        if not self.integrated and not cfg.network.p_nf:
            raise NotImplementedError("non-integrated mode requires network.p_nf (realnvp)")
        self.device = resolve_device(device)
        tpu = cfg.tpu
        shape = dict(hypo=int(tpu.mesh_hypo or 1), tp=int(tpu.tp or 1), pp=int(tpu.pp or 1))
        self.fsdp, self.tp, self.pp = bool(tpu.fsdp), shape["tp"] > 1, shape["pp"] > 1
        self.rank, size = mesh_lib.world()
        self.mesh = None
        if size > 1 or math.prod(shape.values()) > 1:
            n_dev = mesh_lib.fit_devices(cfg.training.batch_size, n_available=size, **shape)
            self.mesh = mesh_lib.make_mesh(n_dev, **shape)
        os.makedirs(cfg.model_dir, exist_ok=True)
        if self.rank == 0:
            self.log = get_logger(os.path.join(cfg.model_dir, f"info_{cfg.training.mode}.log"),
                                  name=f"mhent_{id(self)}")
            self.writer = ScalarWriter(cfg.model_dir)
        else:
            self.log = logging.getLogger(f"mhent_{id(self)}")
            self.log.addHandler(logging.NullHandler())
            self.log.propagate = False
            self.writer = _NullWriter()
        self.log.info(str(cfg))
        if self.mesh is not None:
            self.log.info(f"mesh {self.mesh.shape}, fsdp {self.fsdp}")
        Experiment._live.add(self)
        # The finaliser owns the sinks, not self, or it would never run.
        self._finalizer = weakref.finalize(self, _close_sinks, self.writer, self.log)
        self.model_cfg = build_model_config(cfg) if self.integrated else build_rle_config(cfg)
        self.model = load_mano_model(mano_dir, device=self.device)
        self.fold = mano_lib.fold_keypoints(self.model)
        seed = cfg.training.seed
        self.seed = int(seed) if seed is not None else int(time.time()) % 10000
        self.masters = bool(cfg.training.epochs)
        self.optimizer = None
        self.steps_per_epoch = None
        self.step = 0
        self.losses = []  # every train step's loss, read on the host at log points
        self._pending_opt = None
        self._lib = mhent if self.integrated else rle
        net = self._lib.init(self.model_cfg, seed=self.seed)
        if cfg.training.pth:
            ckpt = self._restore(net, cfg.training.pth)
            self._pending_opt = ckpt.get("optimizer")
            self.step = int(ckpt.get("step", 0))
        self.net = self._lib.prepare(net, self.device, masters=self.masters)
        if self.mesh is not None and self.integrated:
            # Stored split from here on (tpu.fsdp's ZeRO-3, tp's blocks); the
            # RLE mode is data-parallel, as JAX's RLE steps.
            sharded.distribute(self.net, self.mesh, fsdp=self.fsdp, tp=self.tp)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.quant_spec = None
        self.qtree = None
        self._train_step = None

    def close(self) -> None:
        """Close the log file and the scalar writer; idempotent. The
        Experiment cannot train or evaluate after it (its scalar writer is
        closed)."""
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def _restore(net, path: str) -> dict:
        """Load a .pth in the reference's schema into net (an MHEnt:
        {"encoderRGB": state_dict, ...} or a bare state_dict; an RLE:
        {"encoderRGB", "p_nf"}); returns the checkpoint dict."""
        if not path.endswith(".pth"):
            raise NotImplementedError(
                f"{path!r}: orbax checkpoints are read by the JAX package only; convert this "
                f"one with `python orbax_to_pth.py {path} out.pth` and pass the .pth")
        ckpt = torch.load(path, map_location="cpu")
        if isinstance(net, rle.RLE):
            rle.load_checkpoint(net, ckpt)
        else:
            convert.load_reference_state(net, ckpt)
        return ckpt

    def _draws(self, target: dict, bs: int):
        """One step's noise: the reverse-KL draw's (n_train_hypotheses * B,
        45) for an MHEnt; for the RLE mode `rle.draws`."""
        mc = self.model_cfg
        if self.integrated:
            return (torch.randn((mc.n_train_hypotheses * bs, mc.flow.dim), generator=self.gen,
                                device=self.device),)
        return rle.draws(mc, target["pose3d" if mc.pe == "3d" else "crop_uv"], self.gen)

    def make_datasets(self, which=("train", "eval")):
        """(train, eval), None for a split not asked: the loader of
        dataset.dataset_name over tpu.data_dir, else the synthetic fixture.

        tpu.target_fields "auto" has the loaders skip the heavy target
        fields (clouds, heatmaps, per-pixel masks) that no loss reads;
        "full" keeps the reference's whole target. tpu.sample_cache serves
        the train split's deterministic prefix and the whole eval item from
        disk (the eval split only when its items draw no RNG)."""
        name = self.cfg.dataset.dataset_name
        tpu = self.cfg.tpu
        if tpu.data_dir:
            from mhentropy_tpu_torch.data import cached, freihand, ho3d, mixed, rhd

            if tpu.decode_cache:
                data_common.set_decode_cache(tpu.decode_cache)
            loader = {"ho3d": ho3d, "rhd": rhd, "freihand": freihand,
                      "mixed_ho3d_rhd": mixed}.get(name)
            if loader is None:
                raise NotImplementedError(name)
            use_mask = getattr(self.model_cfg, "use_mask_loss", False)
            heavy = None
            if tpu.target_fields != "full":
                # The mask likelihood reads the hand mask: HO3D's hand_mask
                # or RHD's mask (each loader gates on its own key).
                heavy = {"hand_mask", "mask"} if use_mask else set()
            kw = dict(heavy_fields=heavy, image_u8=bool(tpu.image_u8),
                      device_st=bool(tpu.device_st))
            if name == "mixed_ho3d_rhd":
                # A loss input present on one member only fails here, not
                # on the first mixed batch.
                required = set()
                if getattr(self.model_cfg, "use_chamfer_loss", False):
                    required.add("object_verts")
                if use_mask:
                    required.add("hand_mask")
                kw["required"] = required
            train = loader.load(tpu.data_dir, mode="training", prefix_cache=tpu.sample_cache,
                                **kw) if "train" in which else None
            evald = loader.load(tpu.data_dir, mode="evaluation", **kw) \
                if "eval" in which else None
            if tpu.sample_cache and evald is not None:
                if cached.eval_deterministic(evald):
                    evald = cached.SampleCache(evald, tpu.sample_cache)
                else:
                    self.log.info("sample_cache skipped: eval items draw RNG (full "
                                  "target_fields with the RHD cloud?)")
            return train, evald
        img = self.model_cfg.image_size
        bs = self.cfg.training.batch_size
        ds = name if name in ("rhd", "ho3d", "freihand") else "ho3d"
        train = synthetic.make_dataset(self.model, n=max(4 * bs, 32), image_size=img,
                                       seed=self.seed, ds=ds) if "train" in which else None
        evald = synthetic.make_dataset(self.model, n=max(2 * bs, 32), image_size=img,
                                       seed=self.seed + 1, ds=ds) if "eval" in which else None
        return train, evald

    def _get_optimizer(self, steps_per_epoch: int) -> Optimizer:
        t = self.cfg.training
        return make_optimizer(self.net, t.lr, t.milestones, steps_per_epoch)

    def _ensure_state(self, steps_per_epoch: int) -> None:
        """The optimizer for this schedule. A restored checkpoint's optimizer
        state is loaded into the first one built. An optimizer sized for
        another number of steps per epoch is rebuilt while no update has
        been taken (the JAX step rebuilds after an eval sized it); after
        that the Adam moments and the schedule are kept, with a warning."""
        if self.optimizer is not None and steps_per_epoch != self.steps_per_epoch:
            if self.optimizer.count == 0:
                self.log.info(f"rebuilding optimizer: steps_per_epoch {self.steps_per_epoch} -> "
                              f"{steps_per_epoch}")
                self.optimizer = None
            else:
                self.log.warning(f"steps_per_epoch changed {self.steps_per_epoch} -> "
                                 f"{steps_per_epoch} on an already-trained state (step "
                                 f"{self.optimizer.count}); keeping the existing optimizer and "
                                 f"schedule")
        if self.optimizer is None:
            self.steps_per_epoch = steps_per_epoch
            self.optimizer = self._get_optimizer(steps_per_epoch)
            if self._pending_opt is not None:
                self._load_optimizer(self._pending_opt)
                self._pending_opt = None
            self._train_step = (
                make_train_step(self.model, self.net, self.optimizer, fold=self.fold,
                                generator=self.gen, mesh=self.mesh, tp=self.tp, pipe=self.pp)
                if self.integrated else make_rle_train_step(self.net, self.optimizer,
                                                            mesh=self.mesh))

    def _load_optimizer(self, state: dict) -> None:
        """A .pth's optimizer: the port's own state_dict, or Adam moments by
        parameter name with their update count (orbax_to_pth.py's)."""
        if "adam" in state:
            self.optimizer.load_state_dict(state)
        else:
            self.optimizer.load_moments(dict(self.net.named_parameters()), state)

    def _latest_checkpoint(self):
        """(epoch, path) of the newest per-epoch checkpoint that save_model
        wrote in model_dir (`baseline_<decoder_type>_<epoch>.pth`), or None."""
        tag = re.escape(f"baseline_{self.cfg.network.decoder_type}_")
        model_dir = self.cfg.model_dir
        best = None
        for name in os.listdir(model_dir) if os.path.isdir(model_dir) else ():
            m = re.fullmatch(tag + r"(\d+)\.pth", name)
            path = os.path.join(model_dir, name)
            if m and os.path.isfile(path) and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), path)
        return best

    def _resume(self, path: str) -> None:
        """The weights, the optimizer's moments and schedule position and
        the step count of a checkpoint that save_model wrote."""
        ckpt = self._restore(self.net, path)
        if ckpt.get("optimizer") is not None:
            self._load_optimizer(ckpt["optimizer"])
        self.step = int(ckpt.get("step", 0))

    def train_baseline(self):
        """The initial eval, then `training.epochs` epochs of train steps, an
        eval every eval_interval epochs and a checkpoint every save_interval
        (and a final one). Returns the last eval's summary; epochs 0 runs the
        initial eval only. tpu.autoresume: the newest per-epoch checkpoint
        in model_dir restores weights, Adam moments and step, and training
        continues at its next epoch without the initial eval."""
        epochs = self.cfg.training.epochs
        if not epochs:
            _, eval_data = self.make_datasets(which=("eval",))
            return self.eval_loop(eval_data, epoch=0)
        if not self.masters:
            raise RuntimeError("training needs f32 master weights: construct the Experiment "
                               "with training.epochs > 0")
        train_data, eval_data = self.make_datasets()
        bs = self.cfg.training.batch_size
        self._ensure_state(max(1, _num_samples(train_data) // bs))
        start_epoch, summary = 0, None
        latest = self._latest_checkpoint() if self.cfg.tpu.autoresume else None
        if latest:
            epoch_done, path = latest
            self._resume(path)
            start_epoch = epoch_done + 1
            self.log.info(f"autoresume: restored {path} (epoch {epoch_done}), continuing at "
                          f"epoch {start_epoch}")
        else:
            summary = self.eval_loop(eval_data, epoch=0)
        for epoch in range(start_epoch, epochs):
            self.train_epoch(train_data, epoch)
            if (epoch + 1) % self.cfg.eval_interval == 0:
                summary = self.eval_loop(eval_data, epoch=epoch)
            if epoch % self.cfg.save_interval == 0:
                self.save_model(f"baseline_{self.cfg.network.decoder_type}", epoch)
        self.save_model("baseline_final")
        return summary

    def train_epoch(self, data, epoch: int) -> float:
        """One pass over `data` in the epoch's shuffled order (the loaders'
        augmentation stream advanced to `epoch`); the losses are read on the
        host only at log points and at the end. Returns the epoch's mean
        loss."""
        bs = self.cfg.training.batch_size
        if hasattr(data, "set_epoch"):
            data.set_epoch(epoch)
        self.net.train()
        pending, epoch_losses = [], []

        def drain():
            if pending:
                epoch_losses.extend(torch.stack(pending).tolist())
                pending.clear()

        for idx, (image, target) in enumerate(data_common.prefetch(data_common.batches(
                data, bs, shuffle=True, seed=self.seed + epoch, pad_remainder=True,
                device=self.device))):
            aux = self._train_step(image, target, *self._draws(target, bs))
            pending.append(aux["loss"])
            self.step += 1
            if idx % self.cfg.info_interval == 0:
                drain()
                names = [k for k in ("h_q", "q_log_p", "sigma_i") if k in aux]
                extras = torch.stack([aux[k] for k in names]).tolist()
                avg = sum(epoch_losses) / len(epoch_losses)
                self.log.info(f"Epoch:{epoch}| Step:{idx}| Avg_Loss:{avg:.4f}|"
                              + "".join(f" {k}:{v:.4f}|" for k, v in zip(names, extras)))
                self.writer.add_scalar("loss_avg/loss_total", avg, global_step=self.step)
        drain()
        self.losses.extend(epoch_losses)
        return sum(epoch_losses) / max(1, len(epoch_losses))

    def save_model(self, name: str, epoch: int | None = None) -> str:
        """<model_dir>/<name>[_<epoch>].pth in the reference's schema:
        {"encoderRGB": state_dict, "optimizer": ..., "step": ...}, and
        "p_nf" beside a BasicEnc "encoderRGB" in the RLE mode."""
        tag = name if epoch is None else f"{name}_{epoch}"
        path = os.path.abspath(os.path.join(self.cfg.model_dir, f"{tag}.pth"))
        modules = (rle.checkpoint(self.net) if not self.integrated else
                   {"encoderRGB": {k: v.detach().cpu() for k, v in self.net.state_dict().items()}})
        # Every rank takes part (a sharded optimizer gathers its moments);
        # rank 0 writes.
        opt = self.optimizer.state_dict() if self.optimizer else None
        if self.rank == 0:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save({**modules, "optimizer": opt, "step": self.step}, path)
        self.log.info(f"save model in {path}")
        return path

    def eval(self, name: str | None = None):
        """Evaluate checkpoint `name` (a reference .pth), or the weights at
        hand when None (training.pth was restored at construction)."""
        if name and name != self.cfg.training.pth:
            if not os.path.isfile(os.path.abspath(name)):
                raise FileNotFoundError(f"eval(name={name!r}): no checkpoint at "
                                        f"{os.path.abspath(name)}")
            self._restore(self.net, name)
            self.net = self._lib.prepare(self.net, self.device, masters=self.masters)
        _, eval_data = self.make_datasets(which=("eval",))
        return self.eval_loop(eval_data)

    def _quant_spec(self, batch_size: int):
        """The QuantSpec of the int8 eval (tpu.quantize_encoder), or None
        (always for the RLE mode)."""
        tpu = self.cfg.tpu
        if not (self.integrated and tpu.quantize_encoder):
            return None
        img, backbone = self.model_cfg.image_size, self.model_cfg.encoder.backbone
        return quant_mod.QuantSpec(
            backbone=backbone,
            q_from=quant_mod.resolve_q_from(tpu.quantize_q_from, backbone,
                                            (batch_size, img, img, 3), self.device),
            dtype=self.model_cfg.encoder.dtype,
            int8_sampler=bool(tpu.quantize_sampler) and quant_mod.sampler_supported(
                self.model_cfg))

    def eval_loop(self, data, epoch: int = 0, n: int | None = None) -> dict:
        """One pass over `data`: the metrics' means as the JAX loop's
        AverageMeters take them, printed as its summary line. With
        tpu.quantize_encoder the int8 qtree is calibrated on the first batch
        (the sampler at this eval's temp)."""
        self.net.eval()
        if self.masters:
            self._lib.refresh_kernel_weights(self.net)
        tr = self.cfg.training
        n = n or tr.test_samples
        bs = tr.batch_size
        temp = tr.eval_temp
        spec = self.quant_spec = self._quant_spec(bs)
        if self.integrated:
            step = make_eval_step(self.model, self.net, n, temp, n_quant=min(tr.test_quant or n, n),
                                  quant_spec=spec, fold=self.fold, generator=self.gen,
                                  mesh=self.mesh, tp=self.tp)
        else:
            step = make_rle_eval_step(self.net, mesh=self.mesh)
        qtree = None
        batch_mets = []
        for image, target in data_common.prefetch(
                data_common.batches(data, bs, pad_remainder=True, device=self.device)):
            if spec is not None and qtree is None:
                with torch.inference_mode(), sharded.whole(self.net):
                    calib = _prep_image(image, target)
                    res = self.net.feat_extractor.res
                    qtree = quant_mod.prepare(spec, res, quant_mod.calibrate(spec, res, calib))
                    if spec.int8_sampler:
                        _, qtree = quant_mod.quantize_sampler_into(spec, qtree, self.net, calib,
                                                                   temp=temp)
                self.qtree = qtree
            draws = self._draws(target, bs)
            if self.integrated:
                hypo = torch.randn((n * bs, self.model_cfg.flow.dim), generator=self.gen,
                                   device=self.device) * temp
                draws = (*draws, hypo, qtree)
            batch_mets.append(step(image, target, *draws))
        # One device-to-host copy per metric, after the loop; the means are
        # the JAX loop's AverageMeters: valid-weighted, a batch whose value
        # is exactly 0 left out of that metric.
        host = {name: torch.stack([torch.as_tensor(m[name], dtype=torch.float32)
                                   for m in batch_mets]).tolist()
                for name in (batch_mets[0] if batch_mets else {})}
        n_valid = host.pop("n_valid", [float(bs)] * len(batch_mets))
        meters = {}
        for name, values in host.items():
            meter = meters[name] = AverageMeter()
            for v, nv in zip(values, n_valid):
                meter.update(v, n=nv)
        summary = {k: m.avg for k, m in meters.items()}
        line = f"Epoch:{epoch}|"
        if "eucLoss_3d_rgb_sample" in summary:
            line += f" eval_3d_rgb:{summary['eucLoss_3d_rgb_sample'] * 1000:.4f}|"
        for k in sorted(summary):
            self.writer.add_scalar(f"metric_eval/{k}", summary[k], self.step)
        self.log.info(line + " " + str({k: round(v, 4) for k, v in summary.items()}))
        return summary


Experiment._live = weakref.WeakSet()


class _NullWriter:
    """The scalar sink of a rank other than 0: writes nothing."""

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _close_sinks(writer: ScalarWriter, log) -> None:
    """Close the writer and the log's handlers, and drop the per-instance
    logger from logging's registry so that it does not outlive the
    Experiment."""
    writer.close()
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)
    logging.Logger.manager.loggerDict.pop(log.name, None)


def close_all_experiments() -> None:
    """Close every live Experiment's log and scalar sinks."""
    for exp in list(Experiment._live):
        exp.close()
