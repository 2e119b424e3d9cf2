"""Content-hashed encoded-shard cache for federated onboarding
(counterpart of ``fed_tgan_tpu/federation/init_cache.py``).

A re-run of init over an unchanged population repays every fit for
nothing.  The cache keys init state on sha256 fingerprints of the bytes
that determine it, so a hit is the same computation and restores the same
bits:

- **client entries** (``client-<fp>.json``), one per shard fingerprint:
  the local meta dict and the shard's local mixture fits.  The fingerprint
  covers the preprocessed shard, the schema knobs, the fit parameters and
  :data:`ENCODER_VERSION`.  A local fit depends on nothing global, and the
  batched fit gives a column the same bits whatever its batch-mates
  (:mod:`fed_tgan_torch.features.bgm`), so a client entry stays valid
  while the population around it changes;
- **global entries** (``global-<gkey>.npz`` + ``.json`` manifest), keyed
  on the ordered client fingerprints and the init parameters: the
  harmonized meta, the global mixtures, the similarity scores, the
  weights, the onboarding state and the encoded client matrices.

Every payload is published atomically (a temp file, then ``os.replace``)
with its sha256 beside it; a mismatch or an unreadable file counts as
``corrupt`` and is a miss, which the caller refits and overwrites.  The
``corrupt_cache:nth=N`` fault (:mod:`fed_tgan_torch.testing.faults`)
truncates the N-th store to drill that path.

The files are the JAX package's, and a shard's fingerprint equals JAX's
(:func:`shard_fingerprint` hashes the port's column arrays as JAX hashes
its DataFrame).  The operation counts aggregate in :attr:`InitCache.counts`
until :meth:`InitCache.flush_events`, which logs one ``init_cache`` event
dict per (op, scope), with the JAX event's name and fields, and hands
them to :attr:`InitCache.events`.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import tempfile
from typing import Optional

import numpy as np

from fed_tgan_torch.data.csvio import cell_strings
from fed_tgan_torch.features.bgm import ColumnGMM
from fed_tgan_torch.obs.journal import emit as _emit_event

log = logging.getLogger("fed_tgan_torch.federation")

# bump when the encoded representation or the fit pipeline changes shape:
# every fingerprint embeds it, so old entries all miss at once
ENCODER_VERSION = 1

_DIGEST_CHARS = 16


def shard_fingerprint(client, *, n_components: int, backend: str,
                      seed: int) -> str:
    """Content hash of one participant's preprocessed shard (its column
    arrays after ingest) and the knobs that shape its local fit.  A
    column of kind ``i``, ``f``, ``b`` or ``u`` is hashed as its raw
    bytes, any other as its cells' pandas strings joined by ``\\x1f``:
    the bytes JAX's fingerprint reads from the same shard's DataFrame."""
    h = hashlib.sha256()
    h.update(
        f"encoder-v{ENCODER_VERSION}|{backend}|{seed}|{n_components}".encode())
    cols = client.columns
    h.update(repr(list(cols)).encode())
    h.update(repr(sorted(map(str, client.categorical_columns))).encode())
    h.update(repr(sorted(map(str, client.non_negative_columns))).encode())
    h.update(repr(sorted(client.date_formats.items())).encode())
    for values in cols.values():
        values = np.asarray(values)
        if values.dtype.kind in "ifbu":
            h.update(np.ascontiguousarray(values).tobytes())
        else:
            h.update("\x1f".join(str(v) for v in cell_strings(values))
                     .encode())
        h.update(b"\x1e")
    return h.hexdigest()[:_DIGEST_CHARS]


def global_key(fingerprints: list, **params) -> str:
    """Key over the ORDERED client fingerprints and the init parameters
    (client order sets the transform seeds and the weights' layout)."""
    h = hashlib.sha256()
    h.update("|".join(fingerprints).encode())
    h.update(repr(sorted(params.items())).encode())
    return h.hexdigest()[:_DIGEST_CHARS]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _maybe_corrupt(path: str) -> None:
    from fed_tgan_torch.testing.faults import active_plan

    plan = active_plan()
    if plan is not None:
        plan.on_cache_store(path)


class InitCache:
    """One cache directory; counters aggregate until :meth:`flush_events`."""

    def __init__(self, root: str) -> None:
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.counts: dict = {}
        self.events: list = []  # every flushed init_cache event dict

    @classmethod
    def resolve(cls, cache) -> Optional["InitCache"]:
        if cache is None or isinstance(cache, cls):
            return cache
        return cls(str(cache))

    def _note(self, op: str, scope: str) -> None:
        self.counts[(op, scope)] = self.counts.get((op, scope), 0) + 1

    def flush_events(self) -> None:
        """One ``init_cache`` event per (op, scope) since the last flush,
        journaled and appended to :attr:`events`."""
        for (op, scope), count in sorted(self.counts.items()):
            self._emit({"type": "init_cache", "op": op, "scope": scope,
                        "count": count, "root": self.root})
        self.counts.clear()

    def _emit(self, event: dict) -> None:
        _emit_event(**event)
        self.events.append(event)

    # ---------------------------------------------------------- client scope

    def _client_path(self, fp: str) -> str:
        return os.path.join(self.root, f"client-{fp}.json")

    def load_client(self, fp: str) -> Optional[dict]:
        """``{"local_meta": dict, "gmms": {column: ColumnGMM}}`` or None
        (a miss; a digest mismatch or an unreadable file counts
        ``corrupt`` and is a miss)."""
        path = self._client_path(fp)
        if not os.path.exists(path):
            self._note("miss", "client")
            return None
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode())
            payload = doc["payload"]
            blob = json.dumps(payload, sort_keys=True).encode()
            if (doc.get("version") != ENCODER_VERSION
                    or doc.get("sha256") != hashlib.sha256(blob).hexdigest()):
                raise ValueError("digest or version mismatch")
            gmms = {int(j): ColumnGMM.from_dict(d)
                    for j, d in payload["gmms"].items()}
        except (ValueError, KeyError, TypeError, OSError):
            self._note("corrupt", "client")
            return None
        self._note("hit", "client")
        return {"local_meta": payload["local_meta"], "gmms": gmms}

    def store_client(self, fp: str, local_meta: dict, gmms: dict) -> None:
        payload = {"local_meta": local_meta,
                   "gmms": {str(j): g.to_dict() for j, g in gmms.items()}}
        blob = json.dumps(payload, sort_keys=True).encode()
        doc = {"version": ENCODER_VERSION,
               "sha256": hashlib.sha256(blob).hexdigest(),
               "payload": payload}
        path = self._client_path(fp)
        _atomic_write(path, json.dumps(doc, sort_keys=True).encode())
        self._note("store", "client")
        _maybe_corrupt(path)

    # ---------------------------------------------------------- global scope

    def _global_paths(self, gkey: str) -> tuple[str, str]:
        base = os.path.join(self.root, f"global-{gkey}")
        return base + ".npz", base + ".json"

    def load_global(self, gkey: str) -> Optional[dict]:
        """``{"payload": dict, "arrays": {name: ndarray}}`` or None."""
        npz_path, man_path = self._global_paths(gkey)
        if not (os.path.exists(npz_path) and os.path.exists(man_path)):
            self._note("miss", "global")
            return None
        try:
            with open(man_path, "rb") as f:
                manifest = json.loads(f.read().decode())
            if (manifest.get("version") != ENCODER_VERSION
                    or manifest.get("sha256") != _sha256_file(npz_path)):
                raise ValueError("digest or version mismatch")
            with np.load(npz_path, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
            payload = json.loads(str(arrays.pop("payload")[()]))
        except (ValueError, KeyError, TypeError, OSError):
            self._note("corrupt", "global")
            return None
        self._note("hit", "global")
        return {"payload": payload, "arrays": arrays}

    def store_global(self, gkey: str, payload: dict, arrays: dict) -> None:
        npz_path, man_path = self._global_paths(gkey)
        buf = io.BytesIO()
        np.savez(buf, payload=np.asarray(json.dumps(payload, sort_keys=True)),
                 **arrays)
        _atomic_write(npz_path, buf.getvalue())
        manifest = {"version": ENCODER_VERSION,
                    "sha256": _sha256_file(npz_path)}
        _atomic_write(man_path, json.dumps(manifest, sort_keys=True).encode())
        self._note("store", "global")
        _maybe_corrupt(npz_path)
