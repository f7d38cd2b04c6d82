"""Fault-tolerant checkpointing: one npz per leaf, atomic, checksummed (the
port's ``repro.train.checkpoint``, on the reference's on-disk format).

* **atomicity**: a checkpoint directory is written under a temp name and
  ``os.replace``'d into place, so a crash mid-write never corrupts the
  latest good checkpoint;
* **integrity**: every shard file carries a sha256 in ``manifest.json``,
  verified on restore;
* **format**: leaves are saved as full numpy arrays keyed by tree path
  (``/params/blocks/0/attn/wq``), so a float32 checkpoint written by either
  package restores in the other (the JAX package stacks its layers under
  ``/params/blocks/attn/wq``: its trees restore here without a template
  and convert with :func:`repro_torch.models.params.from_jax`).  A bf16
  leaf, which numpy has no dtype for, is saved as its ``uint16`` bits with
  ``"dtype": "bfloat16"`` in the manifest, and restores bit for bit;
* **retention**: keep the last N checkpoints, prune older ones;
* **resume metadata**: step + data cursor in ``extra``.

Restored leaves are torch tensors: on the template leaf's device where a
template is given, else on the CPU.  ``shardings`` (re-layout onto a
mesh) is tensor parallelism, ROADMAP item 9: not ported.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, Any]:
    flat = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}/{i}"))
    else:
        flat[prefix] = tree
    return flat


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, f"{prefix}/{k}") for k in template}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, f"{prefix}/{i}") for i, v in enumerate(template)]
        return type(template)(seq)
    return _to_torch(*flat[prefix], template)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to save, the dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_torch(arr: np.ndarray, dtype: str, like=None) -> torch.Tensor:
    """A saved leaf as a torch tensor, on ``like``'s device where it is a
    tensor (else the CPU)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------------
    def save(
        self,
        step: int,
        params,
        opt_state=None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> str:
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        flat = _flatten(tree)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp-")
        manifest: Dict[str, Any] = {"step": step, "extra": extra or {}, "shards": {}}
        try:
            for i, (path, leaf) in enumerate(sorted(flat.items())):
                arr, dtype = _to_numpy(leaf)
                fn = f"shard-{i:05d}.npz"
                fpath = os.path.join(tmp, fn)
                np.savez(fpath, data=arr)
                with open(fpath, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                manifest["shards"][path] = {
                    "file": fn,
                    "sha256": digest,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.directory, f"ckpt-{step:09d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"ckpt-{s:09d}"), ignore_errors=True)

    # -- load ---------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-"):
                try:
                    out.append(int(name.split("-")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: Optional[int] = None,
        params_template=None,
        opt_template=None,
        shardings=None,
        verify: bool = True,
    ) -> Tuple[Any, Any, Dict[str, Any]]:
        """Restore (params, opt_state, manifest extra with the step)."""
        if shardings is not None:
            raise NotImplementedError("restore onto a mesh (shardings) is tensor parallelism, "
                                      "ROADMAP item 9: not ported")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        cdir = os.path.join(self.directory, f"ckpt-{step:09d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        flat: Dict[str, Any] = {}
        for path, info in manifest["shards"].items():
            fpath = os.path.join(cdir, info["file"])
            if verify:
                with open(fpath, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != info["sha256"]:
                    raise ValueError(f"checksum mismatch in {fpath}")
            flat[path] = (np.load(fpath)["data"], info["dtype"])
        tree = {"params": params_template}
        if opt_template is not None:
            tree["opt_state"] = opt_template
        if params_template is None:
            # reconstruct a nested dict purely from paths
            restored = _paths_to_tree({p: _to_torch(*v) for p, v in flat.items()})
        else:
            restored = _unflatten_into(tree, flat)
        return (restored["params"], restored.get("opt_state"),
                {"step": manifest["step"], **manifest.get("extra", {})})


def _paths_to_tree(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = [p for p in path.split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root
