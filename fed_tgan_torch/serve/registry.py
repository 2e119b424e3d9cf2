"""Artifact discovery, loading and hot reload for the port's format
(counterpart of ``fed_tgan_tpu/serve/registry.py:40-265``).

A run's artifacts live in one ``models`` directory: the
``synthesizer_torch/`` directory, the meta ``<name>.json`` and its paired
``label_encoders_<name>.json``.  A loaded model's identity is the content
hash of its synthesizer files (``checkpoint_fingerprint``), so
:meth:`ModelRegistry.maybe_reload` swaps models exactly when a generation
with other bytes has been published.  The reload is four steps, which the
canary gate (:mod:`fed_tgan_torch.serve.canary`) runs with a score
between them: :meth:`~ModelRegistry.poll_candidate`,
:meth:`~ModelRegistry.load_candidate`, then :meth:`~ModelRegistry.promote`
or :meth:`~ModelRegistry.dismiss`.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import Sequence

from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.runtime.checkpoint import (
    SYNTH_DIR,
    SavedSynthesizer,
    checkpoint_fingerprint,
    is_valid_synthesizer,
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
    loaded_at: float = field(default_factory=time.time)


def load_model(art: ResolvedArtifact, device="cuda") -> LoadedModel:
    """Load the synthesizer onto ``device`` plus the decode artifacts."""
    # the id first: a generation published during the load then gives
    # an id older than the weights, and the next poll reloads
    model_id = checkpoint_fingerprint(art.synth_dir)
    synth = load_synthesizer(art.synth_dir, device=device)
    meta = TableMeta.load_json(art.meta_path)
    with open(art.enc_path) as f:
        encoders = [CategoryEncoder.from_dict(d) for d in json.load(f)]
    return LoadedModel(model_id=model_id, synth=synth, meta=meta,
                       encoders=encoders, artifact=art)


def open_model(root: str, device="cuda", allow_meta_mismatch: bool = False,
               log=print) -> LoadedModel:
    """resolve + freshness check + load: what ``serve`` and
    ``--sample-from`` run at start-up."""
    art = resolve_artifact(root, log=log)
    check_meta_freshness(art, allow=allow_meta_mismatch, log=log)
    return load_model(art, device=device)


class ModelRegistry:
    """A lazily loaded, hot-reloadable model over one artifact root, on
    ``device``.

    ``get()`` loads on first use.  ``maybe_reload()`` is the cheap poll a
    serving worker runs between batches: the stat signature first (mtimes
    and sizes of the synthesizer's files and the meta), then the validity
    probe and the content fingerprint only when the stats moved, then a
    full load only when the bytes changed.  A half-published or torn
    generation is skipped and the current model keeps serving; a
    generation that failed to load is not tried again until another
    publish moves the signature."""

    def __init__(self, root: str, device="cuda",
                 allow_meta_mismatch: bool = False, log=print):
        self.root = root
        self.device = device
        self.allow_meta_mismatch = allow_meta_mismatch
        self._log = log
        self._model: LoadedModel | None = None
        self._stat_sig: tuple | None = None

    def _resolve_checked(self) -> ResolvedArtifact:
        art = resolve_artifact(self.root, log=self._log)
        check_meta_freshness(art, allow=self.allow_meta_mismatch,
                             log=self._log)
        return art

    @staticmethod
    def _stat_signature(art: ResolvedArtifact) -> tuple:
        parts = []
        for p in (os.path.join(art.synth_dir, "config.json"),
                  os.path.join(art.synth_dir, "weights.npz"),
                  art.meta_path):
            try:
                st = os.stat(p)
                parts.append((p, st.st_mtime_ns, st.st_size))
            except OSError:
                parts.append((p, None, None))
        return tuple(parts)

    def get(self) -> LoadedModel:
        if self._model is None:
            art = self._resolve_checked()
            self._model = load_model(art, device=self.device)
            self._stat_sig = self._stat_signature(art)
        return self._model

    def maybe_reload(self) -> bool:
        """Swap in a newer generation if one landed; returns whether a
        reload happened.  Never raises: a generation that fails to load
        is logged once and dismissed, and the current model keeps
        serving."""
        cand = self.poll_candidate()
        if cand is None:
            return False
        try:
            model = self.load_candidate(cand)
        except ArtifactError as exc:
            self._log(f"registry: reload skipped ({exc})")
            self.dismiss(cand)  # not logged again every poll
            return False
        except Exception as exc:  # a torn write raced past the probe
            self._log(f"registry: reload failed ({exc!r}); keeping "
                      f"{self._model.model_id}")
            self.dismiss(cand)  # the next publish moves the signature
            _emit_event("serve_reload_failed", model_id=self._model.model_id,
                        error=repr(exc))
            return False
        self._log(f"registry: hot-reload {self._model.model_id} -> "
                  f"{model.model_id}")
        self.promote(model, cand)
        return True

    # the canary gate scores a candidate between these steps

    def poll_candidate(self) -> "CandidateInfo | None":
        """A loadable-looking new generation, not installed: None when
        nothing new landed, the generation is mid-publish, or it holds the
        serving model's bytes (the stat signature then advances)."""
        if self._model is None:
            return None
        try:
            art = resolve_artifact(self.root, log=lambda *_: None)
        except ArtifactError:
            return None
        sig = self._stat_signature(art)
        if sig == self._stat_sig:
            return None
        if not is_valid_synthesizer(art.synth_dir):
            return None  # mid-publish: caught on a later poll
        try:
            fingerprint = checkpoint_fingerprint(art.synth_dir)
        except OSError:
            return None  # torn mid-read: the next poll
        if fingerprint == self._model.model_id:
            self._stat_sig = sig  # a rewrite of identical bytes
            return None
        return CandidateInfo(artifact=art, sig=sig, fingerprint=fingerprint)

    def load_candidate(self, cand: "CandidateInfo") -> LoadedModel:
        """Load a polled candidate onto the registry's device; raises on a
        torn or mismatched artifact."""
        check_meta_freshness(cand.artifact, allow=self.allow_meta_mismatch,
                             log=self._log)
        return load_model(cand.artifact, device=self.device)

    def promote(self, model: LoadedModel, cand: "CandidateInfo") -> None:
        """Install ``model`` (loaded from ``cand``) as the serving model."""
        self._model = model
        self._stat_sig = cand.sig

    def dismiss(self, cand: "CandidateInfo") -> None:
        """Remember a rejected or unloadable candidate's signature: the
        same bytes are not examined again until a publish moves it."""
        self._stat_sig = cand.sig


@dataclass(frozen=True)
class CandidateInfo:
    """One polled generation, not installed."""

    artifact: ResolvedArtifact
    sig: tuple
    fingerprint: str
