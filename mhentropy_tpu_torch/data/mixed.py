"""Mixed-dataset concatenation, a port of mhentropy_tpu/data/mixed.py
('mixed_ho3d_rhd' in the reference's batch adapter, dataset_transforms.py:12 — named there but never given a loader;
this makes it real): concatenation over member datasets with a shared
target contract.

Members produce different target key sets (HO3D carries verts/object
meshes, RHD carries patch/viewRotation/...), and one collated batch needs
one schema — so items are projected onto the INTERSECTION of the member
key sets. Image normalisation also differs per member (RHD x/255 vs
HO3D's [-1,1]); members keep their own host-side f32 normalisation, so
the uint8 transport (whose device affine is per-sample anyway) is forced
off for a consistent collated dtype.
"""

from __future__ import annotations


class MixedDataset:
    def __init__(self, datasets: list, required=()):
        """Args:
            datasets: member datasets, each yielding (image, target dict).
            required: target keys that must survive the intersection
                projection — config-gated loss inputs (e.g. the chamfer
                term's 'object_verts' exists only on HO3D items) fail
                HERE with a clear message instead of as a
                KeyError on the first mixed batch.

        The common schema is computed EAGERLY from one probe item per
        member: a lazy computation raced the thread-pooled collator
        (several workers each probing every member, consuming a
        nondeterministic number of hidden member-RNG draws). One probe at
        construction costs one deterministic RNG draw per train-mode
        member.
        """
        assert datasets
        self.datasets = datasets
        self._bounds = []
        total = 0
        for ds in datasets:
            total += len(ds)
            self._bounds.append(total)
        key_sets = []
        for ds in datasets:
            _, target = ds[0]
            if not isinstance(target, dict):
                raise TypeError(
                    f"{type(ds).__name__} items must be (image, target "
                    f"dict) to join a MixedDataset; got target of type "
                    f"{type(target).__name__}"
                )
            key_sets.append(set(target.keys()))
        # 'dataset' (a string) survives projection; _collate drops it.
        self._common_keys = set.intersection(*key_sets)
        missing = set(required) - self._common_keys
        if missing:
            raise ValueError(
                f"mixed dataset drops target fields {sorted(missing)} "
                f"that the configured losses consume (present only on a "
                f"subset of members) — disable those loss terms or use "
                f"the single dataset that provides them"
            )

    def __len__(self):
        return self._bounds[-1]

    def set_epoch(self, epoch: int) -> None:
        for ds in self.datasets:
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        prev = 0
        for ds, bound in zip(self.datasets, self._bounds):
            if idx < bound:
                image, target = ds[idx - prev]
                return image, {k: v for k, v in target.items()
                               if k in self._common_keys}
            prev = bound
        raise IndexError(idx)


def load(data_dir: str, mode: str = "training", required=(),
         **kw) -> MixedDataset:
    from mhentropy_tpu_torch.data import ho3d, rhd

    # Force a uniform f32 image contract: RHD would otherwise emit u8
    # while HO3D training emits f32, and one batch cannot mix them.
    kw = dict(kw, image_u8=False)
    return MixedDataset([
        ho3d.load(data_dir, mode=mode, **kw),
        rhd.load(data_dir, mode=mode, **kw),
    ], required=required)
