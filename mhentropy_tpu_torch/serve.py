"""Serving for the MHEnt inference pipeline on PyTorch.

Port of mhentropy_tpu/serve.py: `_buckets` :37, `InferenceServer` :45 (f32
and u8 transports, power-of-two buckets, padded rows dropped, request-major
outputs, int8 serving :54-135,187-225,240-304), `_http_serve` :325 and
`main` :419. The pipeline is encoder -> conditional flow -> MANO decode ->
projection; on a CUDA device the stem, stage 1 and the flow draw run the
port's CUDA kernels, and with `quantize` the buckets of at least
`quantize_min_batch` images run the int8 stage-1 and int8 sampler kernels.

Requests still pad to power-of-two buckets, although PyTorch compiles
nothing per shape: every bucket then has one warmed-up set of kernel
configurations and cuDNN plans, and the HTTP contract stays the JAX one.
Checkpoints: a reference `.pth` loads directly (the names match); orbax
directories raise NotImplementedError until ported.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from mhentropy_tpu_torch import convert
from mhentropy_tpu_torch.core import mano
from mhentropy_tpu_torch.models import mhent, quant
from mhentropy_tpu_torch.train import engine


def _buckets(max_batch: int) -> list[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


class InferenceServer:
    """Bucketed-batch multi-hypothesis inference.

    Args:
        cfg: experiment config (utils/config.py `load_cfg` / `make_cfg`).
        checkpoint: optional reference `.pth` ({'encoderRGB': state_dict}).
        max_batch: largest request batch served in one pass.
        n_hypo: hypotheses per image (the config's test_samples if None).
        temp: sampling temperature (the reference's eval uses 0.8).
        quantize: int8 W8A8 encoder and sampler (models/quant.py). The scales
            calibrate at warmup on zero images, then again on the first real
            int8 batch, and stay fixed after that. The sampler calibrates at
            max(1, temp); a request hotter than that is served float.
        quantize_min_batch: smallest bucket served int8; smaller buckets
            stay float.
        transports: input dtypes warmup() runs: uint8 requests carry raw
            pixels normalised on the device with the dataset's affine;
            float32 requests are already normalised.
        device: torch device; the card when None (raises without one: pass
            device="cpu" to serve on the CPU).
        seed: seeds the fresh weights (no checkpoint) and the base noise.
    """

    def __init__(self, cfg, checkpoint: str | None = None, max_batch: int = 8,
                 n_hypo: int | None = None, temp: float = 0.8, quantize: bool = False,
                 quantize_min_batch: int = 8, transports: tuple = ("f32", "u8"),
                 mano_dir: str = "./mano/", device=None, seed: int = 0):
        self.device = engine.resolve_device(device)
        self.cfg = cfg
        self.model_cfg = engine.build_model_config(cfg)
        self.model = engine.load_mano_model(mano_dir, device=self.device)
        if engine.mano_fingerprint(mano_dir) is None:
            print(f"WARNING: no MANO assets under {mano_dir!r} — serving with the "
                  f"SYNTHETIC stand-in model; real-checkpoint outputs will be "
                  f"garbage (pass --mano)", file=sys.stderr, flush=True)
        self.fold = mano.fold_keypoints(self.model)
        self.n_hypo = int(n_hypo or cfg.training.test_samples)
        self.temp = float(temp)
        self.max_batch = int(max_batch)
        self.image_size = self.model_cfg.image_size

        net = mhent.init(self.model_cfg, seed=seed)
        if checkpoint:
            self._restore(net, checkpoint)
        self.net = mhent.prepare(net, self.device)

        self.transports = tuple(transports)
        name = cfg.dataset.dataset_name
        if name.startswith("ho3d"):
            self.image_norm = (2.0 / 255.0, -1.0)
        elif name.startswith("rhd") or name.startswith("freihand"):
            self.image_norm = (1.0 / 255.0, 0.0)
        else:
            # mixed (per-member affines) or unknown: no single u8 affine.
            self.image_norm = None
            self.transports = tuple(t for t in self.transports if t != "u8")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.quantize = bool(quantize)
        self.quantize_min_batch = int(quantize_min_batch)
        if self.quantize and self.max_batch < self.quantize_min_batch:
            print(f"WARNING: --quantize requested but max_batch {self.max_batch} < "
                  f"quantize_min_batch {self.quantize_min_batch}: every bucket will serve "
                  f"float", file=sys.stderr, flush=True)
        self._quant = None  # (spec, qtree)
        self._quant_ready = False  # calibrated on real data yet?

    @staticmethod
    def _restore(net: mhent.MHEnt, path: str) -> None:
        if not path.endswith(".pth"):
            raise NotImplementedError(
                f"{path!r}: orbax checkpoints are read by the JAX package only; convert this "
                f"one with `python orbax_to_pth.py {path} out.pth` and pass the .pth")
        convert.load_reference_state(net, torch.load(path, map_location="cpu"))

    def _normalised(self, images: np.ndarray) -> torch.Tensor:
        # HTTP bodies arrive as read-only buffers; torch wants writable memory.
        x = torch.from_numpy(np.require(images, requirements=["C", "W"])).to(self.device)
        if x.dtype == torch.uint8:
            scale, bias = self.image_norm
            x = x.float() * scale + bias
        return x

    @torch.inference_mode()
    def _run(self, images: np.ndarray, temp: float, base_noise=None, quantized: bool = False):
        out = mhent.sample_hypotheses(
            self.model, self.net, self._normalised(images), n=self.n_hypo, temp=temp,
            mods=("xyz", "uv"), base_noise=base_noise, generator=self._gen, fold=self.fold,
            quant=self._quant if quantized else None)
        return out["xyz"], out["uv"]

    @torch.inference_mode()
    def _calibrate(self, images: np.ndarray, ready: bool) -> None:
        """Build the int8 qtree on one fixed batch shape (the smallest int8
        bucket, the images tiled or cut to it). ready=False marks a
        shape-only calibration (warmup zeros), redone on the first real
        batch."""
        cb = next(b for b in _buckets(self.max_batch) if b >= self.quantize_min_batch)
        calib = self._normalised(images).float()
        calib = calib.repeat(-(-cb // calib.shape[0]), 1, 1, 1)[:cb]
        spec, qtree = quant.quantize_encoder(self.net.feat_extractor, calib,
                                             q_from=self.cfg.tpu.quantize_q_from)
        if self.cfg.tpu.quantize_sampler and quant.sampler_supported(self.model_cfg):
            spec, qtree = quant.quantize_sampler_into(spec, qtree, self.net, calib,
                                                      temp=max(1.0, self.temp))
        self._quant = (spec, qtree)
        self._quant_ready = ready

    def _quantized_bucket(self, bucket: int) -> bool:
        return self.quantize and bucket >= self.quantize_min_batch

    def warmup(self) -> None:
        """Run every (bucket, transport) once, which also builds the kernels."""
        for b in _buckets(self.max_batch):
            for t in self.transports:
                dt = {"f32": np.float32, "u8": np.uint8}[t]
                img = np.zeros((b, self.image_size, self.image_size, 3), dt)
                q = self._quantized_bucket(b)
                if q and self._quant is None:
                    self._calibrate(img, ready=False)
                self._run(img, self.temp, quantized=q)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, images: np.ndarray, temp: float | None = None,
                base_noise: torch.Tensor | None = None) -> dict:
        """(B, H, W, 3) images -> {"xyz": (B, N, K, 3), "uv": (B, N, K, 2)}.

        float32 inputs are dataset-normalised by the caller; uint8 inputs are
        raw pixels, normalised on the device. B may be anything; it pads to
        the nearest bucket. base_noise, for tests, is the (N * bucket, 45)
        hypothesis-major base noise already times temp.
        """
        images = np.asarray(images)
        if images.dtype == np.uint8 and self.image_norm is None:
            raise ValueError(
                "raw-u8 transport is unavailable for this dataset config (no single "
                "normalisation affine) — send float32 pre-normalised frames")
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        if images.ndim == 3:
            images = images[None]
        b = images.shape[0]
        if b > self.max_batch:
            parts = [self.predict(images[i:i + self.max_batch], temp)
                     for i in range(0, b, self.max_batch)]
            return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        bucket = next(x for x in _buckets(self.max_batch) if x >= b)
        if bucket != b:
            pad = np.zeros((bucket - b, *images.shape[1:]), images.dtype)
            images = np.concatenate([images, pad])
        t_req = float(self.temp if temp is None else temp)
        use_quant = self._quantized_bucket(bucket)
        if use_quant and t_req > max(1.0, self.temp):
            # The sampler's scales were calibrated at max(1, temp): a hotter
            # draw would saturate its first int8 clip.
            print(f"serve: temp {t_req} exceeds the int8 calibration ceiling "
                  f"{max(1.0, self.temp)}; serving this request float",
                  file=sys.stderr, flush=True)
            use_quant = False
        if use_quant and not self._quant_ready:
            self._calibrate(images, ready=True)
        xyz, uv = self._run(images, t_req, base_noise, quantized=use_quant)
        # (N, B', K*d) -> (B, N, K, d) request-major, padding dropped.
        n = xyz.shape[0]
        xyz = xyz.cpu().numpy().reshape(n, bucket, -1, 3).transpose(1, 0, 2, 3)[:b]
        uv = uv.cpu().numpy().reshape(n, bucket, -1, 2).transpose(1, 0, 2, 3)[:b]
        return {"xyz": xyz, "uv": uv}


def make_http_server(server: InferenceServer, host: str, port: int):
    """Stdlib HTTP front end: POST /predict with a raw image body of shape
    (B, S, S, 3) (header X-Batch: B; X-Dtype: float32 for pre-normalised
    frames (default) or uint8 for raw pixels), JSON hypotheses back;
    GET /healthz for liveness. Returns the unstarted HTTPServer."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    size = server.image_size

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps(
                    {"ok": True, "image_size": size, "n_hypo": server.n_hypo}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path != "/predict":
                self.send_response(404)
                self.end_headers()
                return

            def bad(msg):
                # Drain the body first: answering with unread data in the
                # socket resets the connection on many stacks.
                try:
                    left = int(self.headers.get("Content-Length", 0))
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            break
                        left -= len(chunk)
                except (ValueError, OSError):
                    pass
                body = json.dumps({"error": msg}).encode()
                self.send_response(400)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            try:
                n = int(self.headers.get("Content-Length", 0))
                b = int(self.headers.get("X-Batch", 1))
            except ValueError:
                return bad("non-integer Content-Length/X-Batch")
            dt_name = self.headers.get("X-Dtype", "float32")
            if dt_name not in ("float32", "uint8"):
                return bad(f"unsupported X-Dtype {dt_name!r}")
            want = b * size * size * 3 * np.dtype(dt_name).itemsize
            if b < 1 or n != want:
                return bad(f"body is {n} bytes; X-Batch={b} {dt_name} frames "
                           f"at {size}px need {want}")
            raw = self.rfile.read(n)
            images = np.frombuffer(raw, np.dtype(dt_name)).reshape(b, size, size, 3)
            t0 = time.perf_counter()
            try:
                out = server.predict(images)
            except ValueError as e:  # e.g. u8 frames to an f32-only server
                return bad(str(e))
            ms = (time.perf_counter() - t0) * 1e3
            body = json.dumps({"xyz": out["xyz"].tolist(), "uv": out["uv"].tolist(),
                               "ms": ms}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return HTTPServer((host, port), Handler)


def _http_serve(server: InferenceServer, host: str, port: int):
    httpd = make_http_server(server, host, port)
    print(f"serving on {host}:{httpd.server_address[1]} (image_size={server.image_size}, "
          f"n_hypo={server.n_hypo})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


def main(argv=None):
    import argparse

    from mhentropy_tpu_torch.utils.config import load_cfg

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--ckpt", default=None, help="reference .pth checkpoint")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8711)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 W8A8 encoder and sampler for buckets >= --quantize-min-batch")
    ap.add_argument("--quantize-min-batch", type=int, default=8)
    ap.add_argument("--mano", default="./mano/",
                    help="MANO asset dir (MANO_RIGHT.pkl); absent -> synthetic stand-in")
    ap.add_argument("--transport", choices=("both", "f32", "u8"), default="both",
                    help="input dtypes warmed up (u8 = raw pixels normalised on device)")
    args = ap.parse_args(argv)

    cfg = load_cfg(args.cfg)
    server = InferenceServer(
        cfg, checkpoint=args.ckpt, max_batch=args.max_batch, n_hypo=args.n,
        quantize=args.quantize, quantize_min_batch=args.quantize_min_batch,
        mano_dir=args.mano, device=args.device,
        transports=("f32", "u8") if args.transport == "both" else (args.transport,),
    )
    print("warming buckets:", _buckets(server.max_batch), flush=True)
    server.warmup()
    _http_serve(server, args.host, args.port)


if __name__ == "__main__":
    main()
