"""Model assembly from the YAML schema, the MANO asset loader, the training
step and the multi-hypothesis eval step, and the experiment loop around them.

Port of mhentropy_tpu/train/engine.py: `_fused_bn_mode` :54,
`build_model_config` :63, `load_mano_model` :330 (with `_mano_fingerprint`
:308), `_prep_image` :197, `_prep_batch` :225, `make_optimizer` :338 with
the TrainState :47 / `init_state` :349 it sits in (a module, an optimizer
and a step count here), `make_train_step` :359, `make_eval_step` :426, and
`_num_samples` :304, of `Experiment` `make_datasets` :587 (the RHD,
FreiHAND, HO3D and mixed loaders from tpu.data_dir, the synthetic fixture
without one), `_get_optimizer` :692, `_ensure_state` :718, `train_baseline`
:841, `train_epoch` :876, `_quant_spec` :921, `eval_loop` :950, `eval`
:1016 and `save_model` :1043; and the non-integrated RLE mode that a
`network.enc_type` other than "MHEnt" selects (:505-518): `build_rle_config`
:115, `make_rle_train_step` :249 and `make_rle_eval_step` :280, with
`Experiment`'s branches for it (checkpoints in the reference's RLE schema,
{'encoderRGB', 'p_nf'}). Not ported yet: autoresume and orbax checkpoints
(ROADMAP queue 1, "What training still lacks"; checkpoints are the
reference's .pth).

Both loops feed their steps through `data.common.prefetch` over
`data.common.batches(..., device=)`: a thread builds each batch and copies
it to the device while the step before it runs.

The steps are plain functions of their batch and noise: torch cannot replay
jax.random, so the reverse-KL draw's noise (temperature 1), the eval
hypotheses' noise (times temp) and the RLE step's two draws come from the
caller, as the JAX steps split their keys into independent streams.
"""

from __future__ import annotations

import os
import time

import torch

from mhentropy_tpu_torch.core import camera
from mhentropy_tpu_torch.core import mano as mano_lib
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel
from mhentropy_tpu_torch.data import common as data_common
from mhentropy_tpu_torch.data import synthetic
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent, rle
from mhentropy_tpu_torch.models import quant as quant_mod
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.models.mhent import MHEntConfig
from mhentropy_tpu_torch.models.rle import RLEConfig
from mhentropy_tpu_torch.train import metrics as metrics_lib
from mhentropy_tpu_torch.utils.logging import AverageMeter


def _fused_bn_mode(cfg):
    """cfg.tpu.fused_train_bn -> False | True | mode string (bool() would
    collapse "full" to True)."""
    v = cfg.tpu.fused_train_bn
    return v if isinstance(v, str) else bool(v)


def build_model_config(cfg) -> MHEntConfig:
    """YAML schema -> MHEntConfig."""
    net = cfg.network
    if net.use_mask_loss:
        raise NotImplementedError("the mask likelihood needs the renderer, which is not ported "
                                  "yet (ROADMAP queue 1, \"Rendering and viz\")")
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
        n_train_hypotheses=int(cfg.training.n_train_hypotheses),
        use_chamfer_loss=bool(net.use_chamfer_loss),
        w_chamfer=float(net.w_chamfer),
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


def _prep_batch(image: torch.Tensor, target: dict):
    """Image normalisation plus the orthographic camera `st` fitted from
    pose3d and crop_uv when the loader left it out."""
    image = _prep_image(image, target)
    if "st" not in target and "pose3d" in target and "crop_uv" in target:
        target = dict(target)
        uv = target["crop_uv"]
        k = uv.shape[-1] // 2
        target["st"] = camera.compute_st(target["pose3d"].reshape(-1, k, 3),
                                         uv.reshape(-1, k, 2))
    return image, target


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

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # Stays on the device: no host sync for the clip decision.
        divisor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                              norm / self.max_norm)
        torch._foreach_div_(grads, divisor)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
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
                "exp_avg": torch.empty_like(p).copy_(moments["exp_avg"]),
                "exp_avg_sq": torch.empty_like(p).copy_(moments["exp_avg_sq"]),
            }
        self.count = count


def make_optimizer(net: torch.nn.Module, lr: float, milestones, steps_per_epoch: int,
                   gamma: float = 0.1) -> Optimizer:
    """Adam + MultiStep LR (gamma 0.1) + global-norm clip 1.0 over every
    parameter of `net` (CrossModalHand.py:201-203, 462-467)."""
    return Optimizer(net.parameters(), lr, milestones, steps_per_epoch, gamma=gamma)


def make_train_step(model: ManoModel, net: mhent.MHEnt, optimizer: Optimizer,
                    fold: mano_lib.KeypointFold | None = None):
    """One optimisation step of the reverse-KL objective.

    Returns step_fn(image, target, noise) -> aux {loss, th_norm, bt_norm,
    h_q, q_log_p} as 0-d tensors on the device (nothing is read on the
    host). noise: (n_train_hypotheses * B, 45) standard normal, the
    reverse-KL draw's base noise. The net must be in train mode: its BN
    running statistics are updated in place and its parameters by the
    optimizer. A padded tail batch (target["valid"]) is masked out of the
    loss.
    """
    if fold is None:
        fold = mano_lib.fold_keypoints(model)

    def step_fn(image, target, noise):
        image, target = _prep_batch(image, target)
        out = mhent.reverse_kld(model, net, target, image, base_noise=noise, train=True,
                                fold=fold)
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


def make_eval_step(model: ManoModel, net: mhent.MHEnt, n: int, temp: float,
                   n_quant: int | None = None, quant_spec=None,
                   fold: mano_lib.KeypointFold | None = None):
    """The multi-hypothesis eval step: reverse-KL log p with its entropy
    term, n hypotheses per image (int8 encoder and sampler when quant_spec
    is given), and the BH / WH / diversity metrics.

    Returns eval_fn(image, target, kld_noise, hypo_noise, qtree=None) ->
    {metric: 0-d tensor}; kld_noise (n_train_hypotheses * B, 45) is standard
    normal, hypo_noise (n * B, 45) is already times temp. The hypotheses are
    drawn with mods ("xyz", "uv"): the metrics never read the mesh.
    """
    if fold is None:
        fold = mano_lib.fold_keypoints(model)

    @torch.inference_mode()
    def eval_fn(image, target, kld_noise, hypo_noise, qtree=None):
        image, target = _prep_batch(image, target)
        # One float encoder pass feeds both terms; the int8 draw runs its
        # own int8 encoder, and the reverse-KL term keeps the float feature.
        feat = mhent.extract_feat(net, image)
        out = mhent.reverse_kld(model, net, target, image, base_noise=kld_noise, fold=fold,
                                feat=feat)
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


def _masked_loss(lp: torch.Tensor, target: dict) -> torch.Tensor:
    """-mean log p, a padded tail batch's padding (target["valid"]) masked out."""
    if "valid" in target:
        v = target["valid"]
        return -(lp * v).sum() / (v.sum() + 1e-16)
    return -lp.mean()


def make_rle_train_step(net: rle.RLE, optimizer: Optimizer):
    """One optimisation step of the RLE density loss -log p.

    Returns step_fn(image, target, noise, base_noise) -> aux {loss, sigma_i}
    as 0-d tensors on the device; noise and base_noise as
    `rle.loss_and_predict` takes them. The net must be in train mode.
    """
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


def make_rle_eval_step(net: rle.RLE):
    """The RLE eval step: log p and the K1 draws scored by the BH / WH /
    diversity metrics, plus loss_total and sigma_i.

    Returns eval_fn(image, target, noise, base_noise) -> {metric: 0-d tensor}.
    """
    @torch.inference_mode()
    def eval_fn(image, target, noise, base_noise):
        image, target = _prep_batch(image, target)
        out = rle.loss_and_predict(net, image, target, noise=noise, base_noise=base_noise)
        output = {"log_p": out["log_p"]}
        for k in ("xyz", "uv"):
            if k in out:
                output[k] = out[k].reshape(*out[k].shape[:2], -1)
        total, _, mets = metrics_lib.mhent_metrics(output, target,
                                                   image_size=net.cfg.image_size)
        mets = {k: v.mean() for k, v in mets.items()}
        mets["loss_total"] = total
        mets["sigma_i"] = out["sigma_i"]
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
    """

    def __init__(self, cfg, device=None, mano_dir: str = "./mano/"):
        self.cfg = cfg
        self.integrated = cfg.network.enc_type == "MHEnt"
        if not self.integrated and not cfg.network.p_nf:
            raise NotImplementedError("non-integrated mode requires network.p_nf (realnvp)")
        self.device = resolve_device(device)
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
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.quant_spec = None
        self.qtree = None
        self._train_step = None

    @staticmethod
    def _restore(net, path: str) -> dict:
        """Load a .pth in the reference's schema into net (an MHEnt:
        {"encoderRGB": state_dict, ...} or a bare state_dict; an RLE:
        {"encoderRGB", "p_nf"}); returns the checkpoint dict."""
        if not path.endswith(".pth"):
            raise NotImplementedError(
                f"{path!r}: orbax checkpoints are not ported yet (ROADMAP queue 1, \"What "
                f"training still lacks\"); pass a reference .pth")
        ckpt = torch.load(path, map_location="cpu")
        if isinstance(net, rle.RLE):
            rle.load_checkpoint(net, ckpt)
        else:
            net.load_state_dict(ckpt.get("encoderRGB", ckpt), strict=True)
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
            # The mask likelihood, which would request the hand masks, is
            # refused by build_model_config.
            heavy = None if tpu.target_fields == "full" else set()
            kw = dict(heavy_fields=heavy, image_u8=bool(tpu.image_u8),
                      device_st=bool(tpu.device_st))
            if name == "mixed_ho3d_rhd":
                # A loss input present on one member only fails here, not
                # on the first mixed batch.
                kw["required"] = ({"object_verts"}
                                  if getattr(self.model_cfg, "use_chamfer_loss", False) else set())
            train = loader.load(tpu.data_dir, mode="training", prefix_cache=tpu.sample_cache,
                                **kw) if "train" in which else None
            evald = loader.load(tpu.data_dir, mode="evaluation", **kw) \
                if "eval" in which else None
            if tpu.sample_cache and evald is not None:
                if cached.eval_deterministic(evald):
                    evald = cached.SampleCache(evald, tpu.sample_cache)
                else:
                    print("sample_cache skipped: eval items draw RNG (full target_fields with "
                          "the RHD cloud?)", flush=True)
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
                print(f"rebuilding optimizer: steps_per_epoch {self.steps_per_epoch} -> "
                      f"{steps_per_epoch}", flush=True)
                self.optimizer = None
            else:
                print(f"WARNING: steps_per_epoch changed {self.steps_per_epoch} -> "
                      f"{steps_per_epoch} on an already-trained state (step "
                      f"{self.optimizer.count}); keeping the existing optimizer and schedule",
                      flush=True)
        if self.optimizer is None:
            self.steps_per_epoch = steps_per_epoch
            self.optimizer = self._get_optimizer(steps_per_epoch)
            if self._pending_opt is not None:
                self.optimizer.load_state_dict(self._pending_opt)
                self._pending_opt = None
            self._train_step = (
                make_train_step(self.model, self.net, self.optimizer, fold=self.fold)
                if self.integrated else make_rle_train_step(self.net, self.optimizer))

    def train_baseline(self):
        """The initial eval, then `training.epochs` epochs of train steps, an
        eval every eval_interval epochs and a checkpoint every save_interval
        (and a final one). Returns the last eval's summary; epochs 0 runs the
        initial eval only."""
        if self.cfg.tpu.autoresume:
            raise NotImplementedError("tpu.autoresume is not ported yet (ROADMAP queue 1, "
                                      "\"What training still lacks\")")
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
        summary = self.eval_loop(eval_data, epoch=0)
        for epoch in range(epochs):
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
                print(f"Epoch:{epoch}| Step:{idx}| Avg_Loss:{avg:.4f}|"
                      + "".join(f" {k}:{v:.4f}|" for k, v in zip(names, extras)), flush=True)
        drain()
        self.losses.extend(epoch_losses)
        return sum(epoch_losses) / max(1, len(epoch_losses))

    def save_model(self, name: str, epoch: int | None = None) -> str:
        """<model_dir>/<name>[_<epoch>].pth in the reference's schema:
        {"encoderRGB": state_dict, "optimizer": ..., "step": ...}, and
        "p_nf" beside a BasicEnc "encoderRGB" in the RLE mode."""
        tag = name if epoch is None else f"{name}_{epoch}"
        path = os.path.abspath(os.path.join(self.cfg.model_dir, f"{tag}.pth"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        modules = (rle.checkpoint(self.net) if not self.integrated else
                   {"encoderRGB": {k: v.detach().cpu() for k, v in self.net.state_dict().items()}})
        torch.save({**modules,
                    "optimizer": self.optimizer.state_dict() if self.optimizer else None,
                    "step": self.step}, path)
        print(f"save model in {path}", flush=True)
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
                                  quant_spec=spec, fold=self.fold)
        else:
            step = make_rle_eval_step(self.net)
        qtree = None
        batch_mets = []
        for image, target in data_common.prefetch(
                data_common.batches(data, bs, pad_remainder=True, device=self.device)):
            if spec is not None and qtree is None:
                with torch.inference_mode():
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
        print(line + " " + str({k: round(v, 4) for k, v in summary.items()}), flush=True)
        return summary
