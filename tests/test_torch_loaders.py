"""The port's dataset loaders (mhentropy_tpu_torch/data/) against the JAX
package's, on the miniature datasets that tests/fixtures_data.py writes.

Both packages run the same host numpy code with the same per-item RNG
streams, so every item must be EQUAL: the same keys, and each field
np.array_equal with the same dtype, in both modes, under both image_u8
settings, target_fields "auto" and "full", device_st on and off, across
set_epoch, through the prefix and sample caches and the decode cache, and
collated into padded batches. No field needed a tolerance.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from mhentropy_tpu.data import cached as jcached
from mhentropy_tpu.data import common as jcommon
from mhentropy_tpu.data import freihand as jfreihand
from mhentropy_tpu.data import ho3d as jho3d
from mhentropy_tpu.data import mixed as jmixed
from mhentropy_tpu.data import rhd as jrhd
from mhentropy_tpu_torch.data import cached, common, freihand, ho3d, mixed, rhd
from tests import fixtures_data
from tests.torch_dist import few_torch_threads  # noqa: F401 (autouse)

LOADERS = {"rhd": (jrhd, rhd), "freihand": (jfreihand, freihand), "ho3d": (jho3d, ho3d),
           "mixed": (jmixed, mixed)}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("loaders")
    r = {"rhd": fixtures_data.build_rhd(str(base / "rhd"), n=3),
         "freihand": fixtures_data.build_freihand(str(base / "freihand"), n=4),
         "ho3d": fixtures_data.build_ho3d(str(base / "ho3d"), n_train=3, n_eval=2)}
    shutil.copytree(r["ho3d"], base / "mixed")
    shutil.copytree(r["rhd"], base / "mixed", dirs_exist_ok=True)
    r["mixed"] = str(base / "mixed")
    return r


def _same(a, b, where=""):
    """Equal values of equal types: arrays by np.array_equal and dtype,
    strings and Python scalars by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_item(got, want, where=""):
    assert len(got) == len(want), where
    _same(got[0], want[0], f"{where} image")
    assert got[1].keys() == want[1].keys(), (where, sorted(got[1]), sorted(want[1]))
    for k in want[1]:
        _same(got[1][k], want[1][k], f"{where} {k}")


def _pair(name, roots, mode, **kw):
    jmod, mod = LOADERS[name]
    return jmod.load(roots[name], mode=mode, **kw), mod.load(roots[name], mode=mode, **kw)


SETTINGS = [(u8, fields, dst) for u8 in (False, True) for fields in ("auto", "full")
            for dst in (False, True)]


@pytest.mark.parametrize("u8,fields,dst", SETTINGS,
                         ids=[f"u8{int(u)}-{f}-st{'dev' if d else 'host'}" for u, f, d in SETTINGS])
@pytest.mark.parametrize("mode", ["training", "evaluation"])
@pytest.mark.parametrize("name", list(LOADERS))
def test_items_equal_jax(roots, name, mode, u8, fields, dst):
    """Every item at epochs 0 and 1; train-mode items change between the
    epochs (the augmentation stream advances), eval-mode items do not."""
    jds, ds = _pair(name, roots, mode, heavy_fields=None if fields == "full" else set(),
                    image_u8=u8, device_st=dst)
    assert len(ds) == len(jds) > 0
    by_epoch = []
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        ds.set_epoch(epoch)
        items = [ds[i] for i in range(len(ds))]
        for i, item in enumerate(items):
            _same_item(item, jds[i], f"{name} {mode} epoch {epoch} item {i}")
        by_epoch.append(items)
    moved = any(not np.array_equal(a[0], b[0]) for a, b in zip(*by_epoch))
    assert moved == (mode == "training")


@pytest.mark.parametrize("name", ["rhd", "freihand", "ho3d"])
def test_prefix_cache_is_bit_identical(roots, tmp_path, name):
    """Train items served through the deterministic-prefix cache (first
    read computes and publishes, second reads the pickle) equal the
    uncached port item and the JAX item."""
    kw = dict(heavy_fields=set(), image_u8=True, device_st=True)
    jds, plain = _pair(name, roots, "training", **kw)
    cache = LOADERS[name][1].load(roots[name], mode="training", prefix_cache=str(tmp_path), **kw)
    for ds in (jds, plain, cache):
        ds.set_epoch(3)
    for i in range(len(plain)):
        want = jds[i]
        _same_item(plain[i], want, f"{name} uncached {i}")
        _same_item(cache[i], want, f"{name} prefix miss {i}")
        _same_item(cache[i], want, f"{name} prefix hit {i}")
    assert sum(len(files) for _, _, files in os.walk(tmp_path)) == len(plain)


def test_sample_cache_round_trip_and_refusals(roots, tmp_path):
    """SampleCache over a deterministic eval split: miss and hit equal the
    JAX item, and the cache directory is the JAX package's (equal
    fingerprints). Train mode and the RNG-consuming RHD cloud are refused."""
    jds, ds = _pair("rhd", roots, "evaluation", heavy_fields=set(), image_u8=True,
                    device_st=True)
    sc = cached.SampleCache(ds, str(tmp_path))
    assert len(sc) == len(ds) and sc.mode == "evaluation"
    assert os.path.basename(sc.dir) == cached.fingerprint(ds) == jcached.fingerprint(jds)
    for i in range(len(ds)):
        _same_item(sc[i], jds[i], f"sample cache miss {i}")
        _same_item(sc[i], jds[i], f"sample cache hit {i}")
    assert len(os.listdir(sc.dir)) == len(ds)
    for name in ("freihand", "ho3d"):
        _, other = _pair(name, roots, "evaluation", heavy_fields=set())
        assert cached.eval_deterministic(other)
        assert cached.fingerprint(other) != cached.fingerprint(ds)
    _, train = _pair("rhd", roots, "training", heavy_fields=set())
    with pytest.raises(ValueError, match="not deterministic"):
        cached.SampleCache(train, str(tmp_path))
    _, cloud = _pair("rhd", roots, "evaluation", heavy_fields=None)
    assert not cached.eval_deterministic(cloud)
    with pytest.raises(ValueError, match="not deterministic"):
        cached.SampleCache(cloud, str(tmp_path))
    _, mix = _pair("mixed", roots, "evaluation", heavy_fields=set())
    assert cached.eval_deterministic(mix)
    assert cached.fingerprint(mix) == jcached.fingerprint(jmixed.load(roots["mixed"],
                                                                      mode="evaluation",
                                                                      heavy_fields=set()))


def test_decode_cache_hit_equals_miss(roots, tmp_path):
    """imread through the decode cache: the miss publishes the .npy at
    decode_cache_file's path, the hit reads it back, both equal to the JAX
    decode and writable; an array written straight to that path is what a
    later imread returns (the route that needs no decoder)."""
    path = os.path.join(roots["rhd"], "training", "color", "00001.png")
    want = jcommon.imread(path)
    common.set_decode_cache(str(tmp_path))
    try:
        miss = common.imread(path)
        assert os.path.isfile(common.decode_cache_file(path))
        hit = common.imread(path)
        for got in (miss, hit):
            _same(got, want, "decode cache")
            assert got.flags.writeable
        other = os.path.join(roots["rhd"], "training", "color", "00002.png")
        planted = np.full((4, 5, 3), 7, np.uint8)
        np.save(common.decode_cache_file(other), planted)
        _same(common.imread(other), planted, "planted")
    finally:
        common.set_decode_cache(None)
    _same(common.imread(path), want, "after the cache is unset")


@pytest.mark.parametrize("name", list(LOADERS))
def test_padded_batches_equal_jax(roots, name):
    """batches(..., pad_remainder=True) over a shuffled epoch: the same
    order, padding and `valid` mask as JAX, string fields dropped; with
    device= the same values as tensors."""
    jds, ds = _pair(name, roots, "training", heavy_fields=set(), image_u8=True, device_st=True)
    kw = dict(shuffle=True, seed=5, pad_remainder=True)
    want = list(jcommon.batches(jds, 2, to_device=False, **kw))
    got = list(common.batches(ds, 2, **kw))
    assert len(got) == len(want) == -(-len(ds) // 2)
    for i, (g, w) in enumerate(zip(got, want)):
        _same_item(g, w, f"{name} batch {i}")
        assert "dataset" not in g[1] and "valid" in g[1]
    tail = len(ds) % 2
    assert got[-1][1]["valid"].tolist() == ([1.0, 0.0] if tail else [1.0, 1.0])
    for i, (image, target) in enumerate(common.batches(ds, 2, device="cpu", **kw)):
        assert isinstance(image, torch.Tensor) and image.device.type == "cpu"
        _same(image.numpy(), got[i][0], f"{name} tensor batch {i} image")
        assert target.keys() == got[i][1].keys()
        for k, v in target.items():
            _same(v.numpy(), got[i][1][k], f"{name} tensor batch {i} {k}")
    dropped = list(common.batches(ds, 2, shuffle=True, seed=5))
    assert len(dropped) == len(ds) // 2 and all("valid" not in t for _, t in dropped)


def test_to_device_packs_every_dtype():
    """to_device's one packed copy gives back each field's dtype, shape and
    values, odd byte sizes included."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (3, 5, 7, 3)).astype(np.uint8)
    target = {"f": rng.randn(3, 7).astype(np.float32), "i": np.arange(3, dtype=np.int64),
              "b": rng.rand(3, 5, 3) > 0.5, "u": rng.randint(0, 255, (3, 1)).astype(np.uint8),
              "d": rng.randn(3, 2), "e": np.zeros((3, 0), np.float32)}
    image, out = common.to_device(images, target, "cpu")
    _same(image.numpy(), images, "images")
    assert out.keys() == target.keys()
    for k, v in target.items():
        _same(out[k].numpy(), v, k)


def test_prefetch_order_and_errors():
    assert list(common.prefetch(iter(range(7)), size=2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("boom")

    it = common.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_mixed_refuses_a_loss_input_one_member_lacks(roots):
    for pkg in (jmixed, mixed):
        with pytest.raises(ValueError, match="object_verts"):
            pkg.load(roots["mixed"], mode="training",
                     required={"object_verts", "patch"}, heavy_fields=set())


def test_fixture_trees_load_with_and_without_a_decoder(tmp_path):
    """mhentropy_tpu_torch/data/fixtures.py's trees: Pillow decodes its PNG
    encoder's files to the arrays written, every loader reads them, and a
    tree written with cache=True gives the same items from the decode cache
    alone (the decoder replaced by one that fails)."""
    from mhentropy_tpu_torch.data import fixtures

    arr = np.random.RandomState(0).randint(0, 255, (5, 7, 3)).astype(np.uint8)
    for a in (arr, arr[..., 0]):
        fixtures.write_png(str(tmp_path / "x.png"), a)
        _same(np.asarray(common.imread(str(tmp_path / "x.png"))), a, "png")
    plain, seeded = tmp_path / "plain", tmp_path / "seeded"
    for root, cache in ((plain, False), (seeded, True)):
        if cache:
            common.set_decode_cache(str(tmp_path / "dc"))
        try:
            fixtures.write_rhd(str(root), 3, 2, size=320, cache=cache)
            fixtures.write_freihand(str(root / "fh"), 10, cache=cache)
            fixtures.write_ho3d(str(root), 2, 1, cache=cache)
        finally:
            common.set_decode_cache(None)
    kw = dict(heavy_fields=set(), image_u8=True, device_st=True)
    want = {}
    for mode in ("training", "evaluation"):
        for name, mod, sub in (("rhd", rhd, ""), ("freihand", freihand, "fh"),
                               ("ho3d", ho3d, "")):
            ds = mod.load(str(plain / sub), mode=mode, **kw)
            assert len(ds) == {"rhd": (3, 2), "freihand": (9, 1), "ho3d": (2, 1)}[name][
                mode == "evaluation"]
            want[name, mode] = [ds[i] for i in range(len(ds))]
    common.set_decode_cache(str(tmp_path / "dc"))
    decode = common._decode
    common._decode = None  # a decode would raise: every image is a cache hit
    try:
        for (name, mode), items in want.items():
            sub = "fh" if name == "freihand" else ""
            ds = LOADERS[name][1].load(str(seeded / sub), mode=mode, **kw)
            for i, item in enumerate(items):
                _same_item(ds[i], item, f"{name} {mode} {i} from the cache")
    finally:
        common._decode = decode
        common.set_decode_cache(None)
