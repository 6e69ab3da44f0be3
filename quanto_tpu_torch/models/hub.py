"""Hub-shaped model resolution, local part only.

PyTorch counterpart of the local half of `quanto_tpu/models/hub.py`:
`from_pretrained` takes a local directory, or a hub id ("org/name") already
in the standard Hugging Face cache layout on disk
(`<cache>/models--org--name/snapshots/<revision>`, `hub.py:56-130`). It never
touches the network: a hub id that is not in a cache raises. Downloads, and
the JAX module's pluggable resolver, wait for a network (ROADMAP.md Queue 1,
item 9).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional


__all__ = ["resolve_model_path", "is_hub_id"]


def is_hub_id(name_or_path: str) -> bool:
    """Hub-id-shaped: "org/name" (one slash), and not an existing local path."""
    if os.path.exists(name_or_path) or name_or_path.startswith((".", "/", "~")):
        return False
    parts = name_or_path.split("/")
    return len(parts) == 2 and all(parts)


def _hf_cache_dirs(cache_dir: Optional[str]) -> Iterator[str]:
    if cache_dir:
        yield cache_dir
    env = os.environ.get("QUANTO_TPU_HF_CACHE") or os.environ.get("HF_HUB_CACHE")
    if env:
        yield env
    hf_home = os.environ.get("HF_HOME")
    if hf_home:
        yield os.path.join(hf_home, "hub")
    yield os.path.expanduser("~/.cache/huggingface/hub")


def _snapshot_complete(path: str) -> bool:
    """A usable snapshot has a config.json and at least one weights file, so
    that an interrupted download never shadows a complete snapshot."""
    if not os.path.isdir(path):
        return False
    names = os.listdir(path)
    return "config.json" in names and any(n.endswith(".safetensors") for n in names)


def _read_ref(path: str) -> str:
    with open(path) as f:
        return f.read().strip()


def _lookup_cache(model_id: str, revision: Optional[str], cache_dir: Optional[str]) -> Optional[str]:
    """The snapshot of `model_id` at `revision` (a ref under `refs/`, or a
    commit prefix) in the first cache that holds a complete one; without a
    revision, the one `refs/main` names, else the newest complete one."""
    folder = "models--" + model_id.replace("/", "--")
    for root in _hf_cache_dirs(cache_dir):
        snap_root = os.path.join(root, folder, "snapshots")
        if not os.path.isdir(snap_root):
            continue
        ref = os.path.join(root, folder, "refs", revision or "main")
        if os.path.exists(ref):
            commit = _read_ref(ref)
            if commit and _snapshot_complete(os.path.join(snap_root, commit)):
                return os.path.join(snap_root, commit)
        if revision:
            for snap in sorted(os.listdir(snap_root)):
                if snap.startswith(revision) and _snapshot_complete(os.path.join(snap_root, snap)):
                    return os.path.join(snap_root, snap)
            continue
        snaps = sorted(
            (os.path.join(snap_root, s) for s in os.listdir(snap_root)), key=os.path.getmtime, reverse=True
        )
        for snap in snaps:
            if _snapshot_complete(snap):
                return snap
    return None


def resolve_model_path(name_or_path: str, revision: Optional[str] = None, cache_dir: Optional[str] = None) -> str:
    """A local checkpoint directory for a local directory or a cached hub id."""
    if os.path.isdir(name_or_path):
        return name_or_path
    if not is_hub_id(name_or_path):
        raise FileNotFoundError(
            f"Model path '{name_or_path}' is neither a local directory nor a hub-id-shaped name (org/name)."
        )
    cached = _lookup_cache(name_or_path, revision, cache_dir)
    if cached is None:
        raise FileNotFoundError(
            f"'{name_or_path}' is not in a local Hugging Face cache, and quanto_tpu_torch does not download: "
            "pre-populate the cache or pass a local directory."
        )
    return cached
