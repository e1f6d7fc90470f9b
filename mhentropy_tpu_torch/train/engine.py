"""Model assembly from the YAML schema, the MANO asset loader, and the
multi-hypothesis eval step and loop.

Port of mhentropy_tpu/train/engine.py: `build_model_config` :63,
`load_mano_model` :330 (with `_mano_fingerprint` :308), `_prep_image` :197,
`_prep_batch` :225, `make_eval_step` :426, and of `Experiment` the
synthetic branch of `make_datasets` :654-667, `train_baseline`'s initial
eval :865-866, `_quant_spec` :921, `eval_loop` :950 and `eval` :1016.
Training (epochs > 0) is not ported yet (ROADMAP queue 1, item 4), nor are
the real-dataset loaders (item 5).

The eval step is a plain function of (image, target, kld noise, hypothesis
noise, qtree): torch cannot replay jax.random, so the reverse-KL draw's
noise (temperature 1) and the hypotheses' noise (times temp) come from the
caller, as the JAX step splits its key into two independent streams.
"""

from __future__ import annotations

import os
import time

import torch

from mhentropy_tpu_torch.core import camera
from mhentropy_tpu_torch.core import mano as mano_lib
from mhentropy_tpu_torch.core.mano import ManoConfig, ManoModel
from mhentropy_tpu_torch.data import synthetic
from mhentropy_tpu_torch.flows.realnvp import RealNVPConfig
from mhentropy_tpu_torch.models import mhent
from mhentropy_tpu_torch.models import quant as quant_mod
from mhentropy_tpu_torch.models.encoder import EncoderConfig
from mhentropy_tpu_torch.models.mhent import MHEntConfig
from mhentropy_tpu_torch.train import metrics as metrics_lib


def build_model_config(cfg) -> MHEntConfig:
    """YAML schema -> MHEntConfig."""
    net = cfg.network
    if net.use_mask_loss:
        raise NotImplementedError("the mask likelihood needs the renderer, which is not ported "
                                  "yet (ROADMAP queue 1, item 10)")
    n_latent = net.nums_latent if net.nums_latent else net.num_latent
    enc = EncoderConfig(
        backbone=net.backbone,
        n_latent=(n_latent, n_latent) if isinstance(n_latent, int) else tuple(n_latent),
        feat_dim=net.feat_dim,
        sigma_act=net.acts,
        deterministic=net.deterministic,
        dtype=cfg.tpu.compute_dtype,
    )
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
        out = mhent.reverse_kld(model, net, target, image, base_noise=kld_noise, fold=fold)
        samples = mhent.sample_hypotheses(
            model, net, image, n=n, n_quant=n_quant if n_quant is not None else n, temp=temp,
            mods=("xyz", "uv"), base_noise=hypo_noise, fold=fold,
            quant=(quant_spec, qtree) if quant_spec is not None else None)
        output = dict(samples)
        output["log_p"] = out["log_p"]
        total, _, mets = metrics_lib.mhent_metrics(output, target,
                                                   image_size=net.cfg.image_size)
        mets = {k: v.mean() for k, v in mets.items()}
        mets["loss_total"] = total
        return mets

    return eval_fn


class Experiment:
    """The eval half of the JAX Experiment: config -> MANO, fresh or restored
    weights on the device, the synthetic eval split, the eval loop.

    device: the card unless the caller passes another one (e.g. "cpu").
    """

    def __init__(self, cfg, device=None, mano_dir: str = "./mano/"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model_cfg = build_model_config(cfg)
        self.model = load_mano_model(mano_dir, device=self.device)
        self.fold = mano_lib.fold_keypoints(self.model)
        seed = cfg.training.seed
        self.seed = int(seed) if seed is not None else int(time.time()) % 10000
        net = mhent.init(self.model_cfg, seed=self.seed)
        if cfg.training.pth:
            self._restore(net, cfg.training.pth)
        self.net = mhent.prepare(net, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.quant_spec = None
        self.qtree = None

    @staticmethod
    def _restore(net: mhent.MHEnt, path: str) -> None:
        if not path.endswith(".pth"):
            raise NotImplementedError(
                f"{path!r}: orbax checkpoints are not ported yet (ROADMAP queue 1, item 4); "
                f"pass a reference .pth")
        ckpt = torch.load(path, map_location="cpu")
        net.load_state_dict(ckpt.get("encoderRGB", ckpt), strict=True)

    def make_datasets(self, which=("train", "eval")):
        """The synthetic fixture: (train, eval), None for a split not asked."""
        if self.cfg.tpu.data_dir:
            raise NotImplementedError(
                f"data_dir {self.cfg.tpu.data_dir!r}: the real-dataset loaders are not ported "
                f"yet (ROADMAP queue 1, item 5); leave tpu.data_dir null for the synthetic set")
        name = self.cfg.dataset.dataset_name
        img = self.model_cfg.image_size
        bs = self.cfg.training.batch_size
        ds = name if name in ("rhd", "ho3d", "freihand") else "ho3d"
        train = synthetic.make_dataset(self.model, n=max(4 * bs, 32), image_size=img,
                                       seed=self.seed, ds=ds) if "train" in which else None
        evald = synthetic.make_dataset(self.model, n=max(2 * bs, 32), image_size=img,
                                       seed=self.seed + 1, ds=ds) if "eval" in which else None
        return train, evald

    def train_baseline(self):
        """epochs: 0 runs the initial eval only; training is not ported."""
        if self.cfg.training.epochs:
            raise NotImplementedError(
                f"training.epochs {self.cfg.training.epochs}: training is not ported yet "
                f"(ROADMAP queue 1, item 4); epochs: 0 runs the initial eval")
        _, eval_data = self.make_datasets(which=("eval",))
        return self.eval_loop(eval_data, epoch=0)

    def eval(self, name: str | None = None):
        """Evaluate checkpoint `name` (a reference .pth), or the weights at
        hand when None (training.pth was restored at construction)."""
        if name and name != self.cfg.training.pth:
            if not os.path.isfile(os.path.abspath(name)):
                raise FileNotFoundError(f"eval(name={name!r}): no checkpoint at "
                                        f"{os.path.abspath(name)}")
            self._restore(self.net, name)
            self.net = mhent.prepare(self.net, self.device)
        _, eval_data = self.make_datasets(which=("eval",))
        return self.eval_loop(eval_data)

    def _quant_spec(self, batch_size: int):
        """The QuantSpec of the int8 eval (tpu.quantize_encoder), or None."""
        tpu = self.cfg.tpu
        if not tpu.quantize_encoder:
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
        """One pass over `data`: valid-weighted metric means, printed as the
        JAX loop's summary line. With tpu.quantize_encoder the int8 qtree is
        calibrated on the first batch (the sampler at this eval's temp)."""
        tr = self.cfg.training
        n = n or tr.test_samples
        bs = tr.batch_size
        temp = tr.eval_temp
        n_quant = min(tr.test_quant or n, n)
        n_kld = self.model_cfg.n_train_hypotheses
        dim = self.model_cfg.flow.dim
        spec = self.quant_spec = self._quant_spec(bs)
        step = make_eval_step(self.model, self.net, n, temp, n_quant=n_quant, quant_spec=spec,
                              fold=self.fold)
        qtree = None
        batch_mets = []
        for image, target in synthetic.batches(data, bs, pad_remainder=True, device=self.device):
            if spec is not None and qtree is None:
                with torch.inference_mode():
                    calib = _prep_image(image, target)
                    res = self.net.feat_extractor.res
                    qtree = quant_mod.prepare(spec, res, quant_mod.calibrate(spec, res, calib))
                    if spec.int8_sampler:
                        _, qtree = quant_mod.quantize_sampler_into(spec, qtree, self.net, calib,
                                                                   temp=temp)
                self.qtree = qtree
            kld = torch.randn((n_kld * bs, dim), generator=self.gen, device=self.device)
            hypo = torch.randn((n * bs, dim), generator=self.gen, device=self.device) * temp
            batch_mets.append(step(image, target, kld, hypo, qtree))
        sums, weights = {}, {}
        for mets in batch_mets:  # one device-to-host copy per metric, after the loop
            mets = {k: float(v) for k, v in mets.items()}
            n_valid = mets.pop("n_valid", float(bs))
            for name, v in mets.items():
                sums[name] = sums.get(name, 0.0) + v * n_valid
                weights[name] = weights.get(name, 0.0) + n_valid
        summary = {k: sums[k] / weights[k] for k in sums}
        line = f"Epoch:{epoch}|"
        if "eucLoss_3d_rgb_sample" in summary:
            line += f" eval_3d_rgb:{summary['eucLoss_3d_rgb_sample'] * 1000:.4f}|"
        print(line + " " + str({k: round(v, 4) for k, v in summary.items()}), flush=True)
        return summary
