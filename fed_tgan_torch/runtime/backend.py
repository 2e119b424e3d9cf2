"""The backend seam of the port: which platform a run uses, whether the
card answers, and what the topology of a multi-process world on it will
be (counterpart of ``fed_tgan_tpu/runtime/backend.py``).

Backends are named by a ``--backend`` spec:

- ``gpu`` -- the CUDA card, the default of every entry point (auto mode,
  a spec of ``None``, means the card too: nothing falls back to the CPU
  on its own);
- ``cpu`` -- the CPU, only when asked for (tests, CI).

``tpu`` and ``plugin:<name>`` are refused with
:class:`BackendNotPortedError`, which names the flags the port takes: the
port runs on a CUDA card or the CPU, and PJRT plugins have no
counterpart.

The card is probed before first use, in a fresh interpreter under a
timeout (:meth:`Backend.probe`): ``import torch;
torch.cuda.init()`` can hang inside CUDA, and a probe in a subprocess
diagnoses that instead of hanging on it.  The probe reports the cards
(count, name, compute capability, power limit from ``nvidia-smi``),
and :meth:`BackendHealth.world` answers for a world of N participants:
which ranks share a card (:func:`participant_card`) and which
process-group backend follows (:func:`process_group_backend`), the same
functions ``parallel/multihost.py`` runs.  A positive probe is cached for
300 s in a uid-scoped stamp; right after it the caller initializes CUDA
in process under a watchdog (:func:`touch_backend_with_watchdog`), which
closes the cache window: a hang there aborts the process with the probe's
diagnosis.

The JAX module's meshes (``client_mesh``, ``host_axis_groups``,
``provision_virtual_cpu``, ``Backend.mesh``/``host_groups``/
``provision``) have no counterpart: the port stacks every client on one
device.  :func:`contracts_dir_for` picks a backend's directory of program
contracts, as JAX's does.

This module imports no torch itself and touches no CUDA: the probe's
parent stays out of CUDA until the probe has answered.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

from fed_tgan_torch.obs.journal import emit as _emit_event

#: the specs the port runs
KNOWN_PLATFORMS = ("cpu", "gpu")
#: the JAX package's specs that the port refuses by name
_REFUSED = ("tpu",)
_PLUGIN_PREFIX = "plugin:"
#: seconds a positive probe vouches for the card
PROBE_CACHE_S = 300

# the probe's child: CUDA initialized in a fresh interpreter, the cards
# described; nothing else runs there
_PROBE_CODE = (
    "import json, torch, torch.distributed as dist\n"
    "torch.cuda.init()\n"
    "n = torch.cuda.device_count()\n"
    "cards = [{'index': i, 'name': torch.cuda.get_device_name(i),\n"
    "          'capability': '%d.%d' % torch.cuda.get_device_capability(i)}\n"
    "         for i in range(n)]\n"
    "print(json.dumps({'count': n, 'cards': cards, 'nccl': bool(\n"
    "    dist.is_available() and dist.is_nccl_available())}))\n"
)


class BackendNotPortedError(ValueError):
    """A ``--backend`` spec of the JAX package that the port does not run
    (``tpu``, ``plugin:<name>``); the message names the flags to use
    (counterpart of ``PluginRegistrationError``: a named error, not a deep
    traceback)."""


def parse_backend(spec):
    """Validate a ``--backend`` spec; returns ``"cpu"``, ``"gpu"`` or
    ``None`` (auto mode: the card).  ``tpu`` and ``plugin:<name>`` raise
    :class:`BackendNotPortedError`; anything else ``ValueError`` with the
    accepted grammar."""
    if spec is None:
        return None
    low = str(spec).strip().lower()
    if low in KNOWN_PLATFORMS:
        return low
    if low in _REFUSED or low.startswith(_PLUGIN_PREFIX):
        raise BackendNotPortedError(
            f"--backend {spec}: the port runs on a CUDA card or the CPU; "
            "use --backend gpu (the default) or --backend cpu (the same as "
            "--device cuda|cpu)")
    raise ValueError(f"unknown backend {spec!r}: expected gpu or cpu")


# ------------------------------------------------------ the world's topology


def participant_card(rank: int, count: int) -> int:
    """The card index of participant ``rank`` (1-based) on a host of
    ``count`` cards: ``(rank - 1) % count``."""
    return (int(rank) - 1) % int(count)


def process_group_backend(n_participants: int, device_type: str,
                          nccl_available: bool, card_count: int) -> str:
    """``nccl`` when every participant has a card of its own on this host
    (NCCL refuses two ranks on one card), ``gloo`` otherwise: several
    participants on one card, or the CPU."""
    if (device_type == "cuda" and nccl_available
            and card_count >= n_participants):
        return "nccl"
    return "gloo"


def world_plan(info: dict, n_participants: int) -> dict:
    """For a world of ``n_participants`` on the probed host ``info``: each
    card's participant ranks, the ranks that share a card, and the
    process-group backend."""
    count = int(info.get("count") or 0)
    by_card: dict = {}
    if count:
        for rank in range(1, n_participants + 1):
            by_card.setdefault(participant_card(rank, count), []).append(rank)
    return {
        "participants": n_participants,
        "ranks_by_card": {str(c): r for c, r in sorted(by_card.items())},
        "shared": sorted(r for ranks in by_card.values() if len(ranks) > 1
                         for r in ranks),
        "process_group": process_group_backend(
            n_participants, "cuda" if count else "cpu",
            bool(info.get("nccl")), count),
    }


# ------------------------------------------------------------------ probing


def backend_initialized() -> bool:
    """True once this process has initialized CUDA."""
    torch = sys.modules.get("torch")
    try:
        return bool(torch is not None and torch.cuda.is_initialized())
    except Exception:
        return False


def power_limits(timeout_s: float = 10.0) -> list:
    """``[(name, power limit), ...]`` as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, one per card; empty
    where the tool is missing or fails."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return []
    try:
        proc = subprocess.run(
            [tool, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if proc.returncode != 0:
        return []
    out = []
    for line in proc.stdout.strip().splitlines():
        name, _, limit = line.rpartition(",")
        out.append((name.strip(), limit.strip()))
    return out


def _describe(stdout: str) -> dict:
    """The probe child's JSON line, with each card's power limit."""
    info = json.loads(stdout.strip().splitlines()[-1])
    limits = power_limits()
    for card in info["cards"]:
        i = card["index"]
        card["power_limit"] = limits[i][1] if i < len(limits) else None
    return info


def _read_stamp(stamp: str):
    """The cached probe's card description, or None when the stamp is
    missing, not a regular file of this uid, or older than the window."""
    import stat

    try:
        st = os.lstat(stamp)  # lstat: never trust a symlinked stamp
        if not (stat.S_ISREG(st.st_mode) and st.st_uid == os.getuid()
                and time.time() - st.st_mtime < PROBE_CACHE_S):
            return None
        fd = os.open(stamp, os.O_RDONLY | os.O_NOFOLLOW)
        with os.fdopen(fd) as fh:
            text = fh.read()
    except OSError:
        return None
    try:
        return json.loads(text) if text.strip() else {}
    except ValueError:
        return {}


def _write_stamp(stamp: str, info: dict) -> None:
    try:
        fd = os.open(stamp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                     | os.O_NOFOLLOW, 0o600)
        with os.fdopen(fd, "w") as fh:
            fh.write(json.dumps(info))
        os.utime(stamp, follow_symlinks=False)
    except OSError:
        pass


def probe_backend_responsive(timeout_s: int = 15, attempts: int = 1,
                             backoff_s: float = 60.0, log=None,
                             ignore_cache: bool = False) -> tuple:
    """Whether ``torch.cuda.init()`` completes in a fresh interpreter and
    finds a card: ``(ok, reason)``, :meth:`Backend.probe` of the card
    with JAX's signature (the doctor's ``--wait-healthy`` waits on it)."""
    health = Backend("gpu").probe(timeout_s=timeout_s, attempts=attempts,
                                  backoff_s=backoff_s, log=log,
                                  ignore_cache=ignore_cache)
    return health.ok, health.reason


def _probe_stamp_path() -> str:
    """Path of the positive-probe stamp: the uid in the key and
    ``O_NOFOLLOW`` on create, so another user's stamp cannot vouch for
    this user's card nor a planted symlink redirect the write."""
    import hashlib
    import tempfile

    key = hashlib.sha256(
        (os.environ.get("CUDA_VISIBLE_DEVICES", "") + sys.executable
         + str(os.getuid())).encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(),
                        f".fed_tgan_torch_cuda_ok_{key}")


def arm_watchdog(timeout_s: float, on_fire, name: str = "watchdog"):
    """A daemon thread that calls ``on_fire()`` unless cancelled within
    ``timeout_s``; returns the cancel callable."""
    import threading

    done = threading.Event()

    def _watch() -> None:
        if not done.wait(timeout_s):
            on_fire()

    threading.Thread(target=_watch, daemon=True, name=name).start()
    return done.set


def _drop_stamp() -> None:
    try:
        os.unlink(_probe_stamp_path())
    except OSError:
        pass


def touch_backend_with_watchdog(timeout_s: float = 180.0, who: str = "",
                                _touch=None, _abort=None,
                                _initialized=None) -> tuple:
    """Initialize CUDA in this process NOW, under a watchdog.

    A run that starts inside a cached probe's window would otherwise meet
    a fresh hang at its first CUDA call.  The watchdog aborts the process
    with the probe's diagnosis when the touch does not return within
    ``timeout_s``: ``os._exit(3)``, because the main thread is stuck in
    CUDA and no Python exception can reach it.  A touch that
    crashes returns ``(False, reason)``.  Both drop the stamp so the next
    run probes for real.  ``_touch``/``_abort``/``_initialized`` are test
    seams."""
    if (_initialized or backend_initialized)():
        return True, ""
    if _touch is None:
        import torch

        _touch = torch.cuda.init

    def _fire() -> None:
        _drop_stamp()
        print(f"{who}CUDA backend unusable (torch.cuda.init() did not "
              f"return within {timeout_s:.0f}s after a positive probe -- the "
              "CUDA init likely hung inside the probe-cache window); aborting "
              "-- retry later or use --backend cpu",
              file=sys.stderr, flush=True)
        (_abort or os._exit)(3)

    cancel = arm_watchdog(timeout_s, _fire, name="backend-touch-watchdog")
    try:
        _touch()
    except Exception as exc:
        _drop_stamp()
        return False, f"CUDA init crashed after a positive probe: {exc}"
    finally:
        cancel()
    return True, ""


# ------------------------------------------------------------- the handle


@dataclasses.dataclass(frozen=True)
class BackendHealth:
    """Result of :meth:`Backend.probe` / :meth:`Backend.touch`: ``ok`` the
    verdict, ``reason`` a failure's narrative (or ``"cached"`` / ``"ok
    after N attempts"``), ``cached`` a verdict vouched for by the stamp,
    ``info`` the cards the probe saw."""

    ok: bool
    reason: str = ""
    cached: bool = False
    backend: str = "cpu"
    info: dict = dataclasses.field(default_factory=dict, compare=False)

    def __bool__(self) -> bool:
        return self.ok

    def world(self, n_participants: int) -> dict:
        """:func:`world_plan` of ``n_participants`` on the probed host."""
        return world_plan(self.info, n_participants)


class Backend:
    """A named platform and the policy for standing it up.  Construction
    is cheap and imports no torch; use :func:`get_backend`."""

    def __init__(self, name: str):
        self.name = parse_backend(name) or "gpu"

    @property
    def is_cpu(self) -> bool:
        return self.name == "cpu"

    @property
    def device(self) -> str:
        """The torch device type this backend runs on."""
        return "cpu" if self.is_cpu else "cuda"

    def __repr__(self) -> str:
        return f"Backend({self.name!r})"

    def probe(self, timeout_s: int = 15, attempts: int = 1,
              backoff_s: float = 60.0, log=None,
              ignore_cache: bool = False) -> BackendHealth:
        """Whether ``torch.cuda.init()`` completes in a fresh interpreter
        under ``timeout_s`` and finds a card; ``info`` is ``{"count",
        "cards": [{"index", "name", "capability", "power_limit"}],
        "nccl"}`` when it does.  The CPU cannot hang, so its probe spawns
        nothing.

        ``reason`` tells a hang from a crash and carries the child's
        stderr tail.  ``attempts`` > 1 retries a failed probe after
        ``backoff_s`` seconds, narrating each failure through ``log``.  A
        success is cached for :data:`PROBE_CACHE_S` seconds in a stamp
        keyed by ``CUDA_VISIBLE_DEVICES``, the interpreter and the uid
        (reason ``"cached"``, the cards read from the stamp); a failure
        never is.  Journals ``backend_probe`` after every real probe."""
        if self.is_cpu:
            return BackendHealth(True, "host platform", backend=self.name)
        stamp = _probe_stamp_path()
        if not ignore_cache:
            # ``ignore_cache``: callers whose whole point is CURRENT
            # liveness (doctor --wait-healthy) must not be vouched for by
            # a stamp that may predate a fresh hang
            cached = _read_stamp(stamp)
            if cached is not None:
                return BackendHealth(True, "cached", cached=True,
                                     backend=self.name, info=cached)

        reason = ""
        for attempt in range(1, max(1, attempts) + 1):
            if attempt > 1:
                if log is not None:
                    log(f"backend probe attempt {attempt - 1}/{attempts} "
                        f"failed ({reason}); retrying in {backoff_s:.0f}s")
                time.sleep(backoff_s)
            try:
                proc = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                                      capture_output=True, text=True,
                                      timeout=timeout_s)
            except subprocess.TimeoutExpired:
                reason = (f"torch.cuda.init() did not return within "
                          f"{timeout_s}s (hung CUDA init)")
                continue
            if proc.returncode != 0:
                tail = (proc.stderr or "").strip().splitlines()[-3:]
                reason = ("backend probe crashed: "
                          + (" | ".join(tail) or f"rc={proc.returncode}"))
                continue
            try:
                info = _describe(proc.stdout)
            except (ValueError, KeyError, IndexError, TypeError):
                info = {}
            if not info.get("count"):
                reason = ("backend probe found no CUDA card: "
                          + (proc.stdout.strip()[-200:] or "no output"))
                continue
            _write_stamp(stamp, info)
            _emit_event("backend_probe", ok=True, attempts=attempt,
                        timeout_s=timeout_s)
            return BackendHealth(
                True, "" if attempt == 1 else f"ok after {attempt} attempts",
                backend=self.name, info=info)
        if attempts > 1:
            span = attempts * timeout_s + (attempts - 1) * backoff_s
            reason += f" (after {attempts} attempts over ~{span:.0f}s)"
        _emit_event("backend_probe", ok=False, reason=reason,
                    timeout_s=timeout_s)
        return BackendHealth(False, reason, backend=self.name)

    def touch(self, timeout_s: float = 180.0, who: str = "") -> BackendHealth:
        """Initialize CUDA now under a watchdog
        (:func:`touch_backend_with_watchdog`); the CPU needs nothing."""
        if self.is_cpu:
            return BackendHealth(True, backend=self.name)
        ok, reason = touch_backend_with_watchdog(timeout_s=timeout_s, who=who)
        return BackendHealth(ok, reason, backend=self.name)

    def record_fields(self) -> dict:
        """``backend``/``platform`` fields for run records: ``platform``
        says ``gpu`` only once this process has initialized CUDA."""
        platform = "cpu"
        if not self.is_cpu and backend_initialized():
            platform = "gpu"
        return {"backend": self.name, "platform": platform}


def get_backend(spec=None) -> Backend:
    """The backend of a ``--backend`` spec; ``None`` (auto mode) is the
    card, as every entry point's default is."""
    return Backend(spec if spec is not None else "gpu")


def contracts_dir_for(backend):
    """The program contracts' directory of a backend
    (``fed_tgan_tpu/runtime/backend.py:547``): ``cpu`` is the checked-in
    ``analysis/contracts/``, which tier-1 checks on the CPU; ``gpu`` (and
    auto mode, the card) its ``gpu/`` subdirectory, recorded on the card,
    where the cross-device copies show.  ``tpu`` and ``plugin:<name>`` are
    refused as :func:`parse_backend` refuses them."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "analysis" / "contracts"
    name = parse_backend(backend) or "gpu"
    return root if name == "cpu" else root / name
