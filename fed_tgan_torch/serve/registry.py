"""Artifact discovery and loading for the port's format
(counterpart of ``fed_tgan_tpu/serve/registry.py:40-162``).

A run's artifacts live in one ``models`` directory: the
``synthesizer_torch/`` directory, the meta ``<name>.json`` and its paired
``label_encoders_<name>.json``.  Hot reload is not ported yet: a
:class:`LoadedModel` is loaded once.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Sequence

from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.runtime.checkpoint import (
    SYNTH_DIR,
    SavedSynthesizer,
    checkpoint_fingerprint,
    load_synthesizer,
)


class ArtifactError(RuntimeError):
    """No loadable run artifact at the requested root."""


class MetaMismatchError(ArtifactError):
    """The newest meta JSON postdates the saved synthesizer."""


@dataclass(frozen=True)
class ResolvedArtifact:
    """Paths of one run's sampling artifacts (nothing loaded yet)."""

    synth_dir: str
    meta_path: str
    enc_path: str
    name: str


def resolve_artifact(root: str, log=print) -> ResolvedArtifact:
    """Locate the synthesizer + meta/encoder pair under ``root``: the
    run's out-dir, its ``models`` dir, or the synthesizer dir itself."""
    root = os.path.abspath(root)
    candidates = [os.path.join(root, "models"), root, os.path.dirname(root)]
    for cand in candidates:
        synth = os.path.join(cand, SYNTH_DIR)
        # a meta JSON counts only with its paired encoder file
        metas = [
            m for m in sorted(glob.glob(os.path.join(cand, "*.json")))
            if os.path.exists(os.path.join(
                cand, "label_encoders_"
                f"{os.path.splitext(os.path.basename(m))[0]}.json"))
        ]
        if os.path.isdir(synth) and metas:
            if len(metas) > 1:
                metas.sort(key=os.path.getmtime)
                log(f"multiple run artifacts in {cand} "
                    f"({[os.path.basename(m) for m in metas]}); using the "
                    f"newest: {os.path.basename(metas[-1])}")
            name = os.path.splitext(os.path.basename(metas[-1]))[0]
            return ResolvedArtifact(
                synth_dir=synth, meta_path=metas[-1],
                enc_path=os.path.join(cand, f"label_encoders_{name}.json"),
                name=name)
    raise ArtifactError(
        f"no {SYNTH_DIR} artifact + meta JSON/encoder pair found under any "
        f"of {candidates}")


def check_meta_freshness(art: ResolvedArtifact, allow: bool = False,
                         log=print) -> None:
    """Reject a meta JSON newer than the saved synthesizer: meta and
    encoders are written before the synthesizer, so a newer meta belongs
    to a later run that never saved a model, and decoding through it
    gives wrong categories or a shape error.  ``allow`` downgrades the
    error to a warning."""
    try:
        synth_mtime = max(os.path.getmtime(os.path.join(art.synth_dir, f))
                          for f in os.listdir(art.synth_dir))
        stale = os.path.getmtime(art.meta_path) > synth_mtime
    except (OSError, ValueError):
        return  # unreadable/empty synth dir: load_synthesizer will explain
    if not stale:
        return
    msg = (f"meta {os.path.basename(art.meta_path)} is newer than the saved "
           "synthesizer: the run that wrote it likely never saved a model")
    if not allow:
        raise MetaMismatchError(f"{msg}; pass --allow-meta-mismatch to "
                                "sample anyway")
    log(f"WARNING: {msg} (proceeding: --allow-meta-mismatch)")


@dataclass
class LoadedModel:
    """One fully-loaded serving model: synthesizer + decode artifacts."""

    model_id: str  # artifact content hash (12 hex chars)
    synth: SavedSynthesizer
    meta: TableMeta
    encoders: Sequence[CategoryEncoder]
    artifact: ResolvedArtifact


def load_model(art: ResolvedArtifact, device="cuda") -> LoadedModel:
    """Load the synthesizer onto ``device`` plus the decode artifacts."""
    synth = load_synthesizer(art.synth_dir, device=device)
    meta = TableMeta.load_json(art.meta_path)
    with open(art.enc_path) as f:
        encoders = [CategoryEncoder.from_dict(d) for d in json.load(f)]
    return LoadedModel(model_id=checkpoint_fingerprint(art.synth_dir),
                       synth=synth, meta=meta, encoders=encoders,
                       artifact=art)


def open_model(root: str, device="cuda", allow_meta_mismatch: bool = False,
               log=print) -> LoadedModel:
    """resolve + freshness check + load: what ``serve`` and
    ``--sample-from`` run at start-up."""
    art = resolve_artifact(root, log=log)
    check_meta_freshness(art, allow=allow_meta_mismatch, log=log)
    return load_model(art, device=device)
