"""Bounded acquisition of the card (the CUDA twin of
``cranesched_tpu/parallel/acquire.py``).

A daemon that touches the card for the first time inside its first
scheduling cycle would do so holding the RPC lock: a wedged driver or a
card that is not there would hang every handler with it.  So the
controller's boot path acquires the card first, as a *bounded,
observable handshake*:

* :func:`preflight_report` -- a stdlib-only snapshot of what the CUDA
  runtime is about to trust: the device nodes (``/dev/nvidia*``), the
  visibility variables (``CUDA_VISIBLE_DEVICES`` and friends), the
  driver library and ``nvidia-smi``.  Taken before torch is imported, so
  a hang cannot blind it.

* :func:`acquire_device` -- the probe: a stdlib-self-contained child
  process stamps the acquisition phases (``env_preflight ->
  torch_import -> cuda_init -> device_enum``, the first four of
  ``obs.flight.PROBE_PHASES``; the rest are the bench probe's, ROADMAP.md
  A12) into an fsync'd heartbeat file.  The parent enforces a hard
  budget; on expiry it harvests the child's ``faulthandler`` stacks via
  SIGUSR1, kills it, emits a typed ``backend_degraded`` event through the
  caller's sink and returns a structured diagnosis.

* :func:`ensure_device` -- the controller's boot-path wrapper: nothing to
  probe when the caller asked for the CPU, the handshake otherwise.

Unlike the JAX package, a failed acquisition never falls back to the
CPU: the port runs on the card unless the caller asks for the CPU, so
the caller gets ``acquired: False`` and stops (``ctld_main`` exits
non-zero with the diagnosis).

``BENCH_ACQUIRE_INJECT_HANG=<phase>`` wedges the named phase on purpose
(the forensics self-test, as in the JAX package).

Metrics: ``crane_backend_acquire_seconds`` (histogram, by outcome) and
``crane_backend_acquire_failures_total`` (counter, by phase).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

from cranesched_tpu_torch.obs.flight import PROBE_PHASES, read_heartbeat
from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS

#: the phases this handshake stamps (the first four of the heartbeat
#: protocol)
ACQUIRE_PHASES = PROBE_PHASES[:4]

#: boot-path budget (seconds); override with CRANE_ACQUIRE_TIMEOUT
DEFAULT_BOOT_TIMEOUT_S = 120.0

_MET_ACQ_SECONDS = _OBS.histogram(
    "crane_backend_acquire_seconds",
    "wall time of the bounded device-acquisition handshake, labeled by "
    "outcome (ok | timeout | error)")
_MET_ACQ_FAILURES = _OBS.counter(
    "crane_backend_acquire_failures_total",
    "device acquisitions that timed out or errored, labeled by the last "
    "heartbeat phase reached (where the handshake wedged)")

_ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
             "CUDA_DEVICE_ORDER", "CUDA_LAUNCH_BLOCKING", "LD_LIBRARY_PATH")


def preflight_report() -> dict:
    """Stdlib-only environment snapshot taken before any torch import --
    the "why could the handshake fail" half of a diagnosis."""
    import ctypes.util
    devs = sorted(glob.glob("/dev/nvidia[0-9]*"))
    env = {k: (v[:120] + "..." if len(v) > 120 else v)
           for k, v in sorted(os.environ.items()) if k in _ENV_KEYS}
    return {
        "cuda_env": env,
        "libcuda": ctypes.util.find_library("cuda") or "(not found)",
        "nvidia_smi": shutil.which("nvidia-smi") or "(not found)",
        "devices": {"dev_nvidia": devs, "visible": len(devs)},
    }


def _preflight_summary(pf: dict) -> str:
    return (f"env pre-flight: libcuda={pf.get('libcuda')!r}, "
            f"nvidia-smi={pf.get('nvidia_smi')!r}, "
            f"/dev/nvidia*={pf.get('devices', {}).get('visible', 0)}, "
            f"env={pf.get('cuda_env') or '(none)'}")


# The probe child (obs/flight.py heartbeat protocol).  Deliberately
# stdlib-self-contained: importing the package here would import torch
# BEFORE the torch_import stamp and blind the phase the probe most
# suspects.  A stamp marks the phase's START, fsync'd before proceeding,
# so on a hang the last line on disk names the phase it died in.
_ACQUIRE_PROBE_SRC = r"""
import faulthandler, json, os, signal, sys, time

hb_path, stack_path = sys.argv[1], sys.argv[2]
hb = open(hb_path, "a", encoding="utf-8")


def stamp(phase):
    hb.write(json.dumps({"t": time.time(), "phase": phase}) + "\n")
    hb.flush()
    os.fsync(hb.fileno())
    if os.environ.get("BENCH_ACQUIRE_INJECT_HANG", "") == phase:
        time.sleep(3600.0)


# the parent harvests this on timeout: SIGUSR1 -> all-thread tracebacks
stack_fh = open(stack_path, "w", encoding="utf-8")
faulthandler.register(signal.SIGUSR1, file=stack_fh, all_threads=True)

stamp("env_preflight")
stamp("torch_import")
import torch

stamp("cuda_init")
torch.cuda.init()
stamp("device_enum")
n = torch.cuda.device_count()
if n < 1:
    raise SystemExit("torch sees no CUDA device")
print(json.dumps({"ok": True, "platform": "cuda", "device_count": n,
                  "device_name": torch.cuda.get_device_name(0)}))
"""


def acquire_device(timeout_s: float, event_sink=None) -> dict:
    """Probe the card ONCE in a subprocess with a hard budget.

    Returns ``{"acquired": True, "platform": "cuda", ...}`` or, on a
    timeout or an error, ``{"acquired": False, "diagnosis": ...}`` naming
    the phase it stopped in, with the child's faulthandler stacks
    (harvested before the kill) and the pre-flight report.
    ``event_sink(type, severity, detail)`` receives a typed
    ``backend_degraded`` event on any failure.  Nothing here falls back
    to the CPU."""
    import signal
    import subprocess
    import tempfile
    import time as _time

    preflight = preflight_report()
    workdir = tempfile.mkdtemp(prefix="crane-acquire-")
    hb_path = os.path.join(workdir, "heartbeat.jsonl")
    stack_path = os.path.join(workdir, "stacks.txt")
    t0 = _time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", _ACQUIRE_PROBE_SRC, hb_path,
         stack_path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    timed_out = False
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        timed_out = True
        # harvest the child's stacks while it is still wedged: SIGUSR1
        # fires its faulthandler dump, then the kill
        try:
            proc.send_signal(signal.SIGUSR1)
            _time.sleep(2.0)
        except OSError:
            pass
        proc.kill()
        out, err = proc.communicate()
    elapsed = round(_time.monotonic() - t0, 1)
    beats = read_heartbeat(hb_path)
    phases = [b["phase"] for b in beats]
    stamps = [{"phase": b["phase"], "t": b["t"]} for b in beats]
    try:
        with open(stack_path, encoding="utf-8") as fh:
            stacks = fh.read().strip()
    except OSError:
        stacks = ""
    shutil.rmtree(workdir, ignore_errors=True)
    if not timed_out and proc.returncode == 0:
        doc = {}
        try:
            doc = json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            pass
        if doc.get("ok"):
            _MET_ACQ_SECONDS.observe(elapsed, outcome="ok")
            return {"acquired": True,
                    "attempts": [{"outcome": "ok", "seconds": elapsed}],
                    "platform": "cuda",
                    "device_count": doc.get("device_count", 0),
                    "device_name": doc.get("device_name", ""),
                    "phases": phases, "phase_stamps": stamps,
                    "preflight": preflight}
    last = phases[-1] if phases else "(no heartbeat — died pre-stamp)"
    if timed_out:
        pos = (f"{ACQUIRE_PHASES.index(last) + 1}/{len(ACQUIRE_PHASES)}"
               if last in ACQUIRE_PHASES else "?")
        attempt = {"outcome": "timeout", "seconds": elapsed,
                   "last_phase": last, "phases": phases}
        diagnosis = (
            f"the CUDA device-acquisition handshake hung in phase "
            f"{last!r} ({pos} of the heartbeat protocol) and did not "
            f"finish within the {timeout_s:g} s budget; "
            f"{'an all-thread stack dump was captured' if stacks else 'no stack dump could be harvested'}. "
            f"{_preflight_summary(preflight)}.")
        _MET_ACQ_SECONDS.observe(elapsed, outcome="timeout")
    else:
        attempt = {"outcome": f"rc={proc.returncode}", "seconds": elapsed,
                   "phases": phases,
                   "tail": ((err or out) or "").strip()[-300:]}
        diagnosis = (
            f"the CUDA device-acquisition handshake exited with "
            f"{attempt['outcome']} after {elapsed} s having reached "
            f"phase {phases[-1] if phases else '(none)'!r} "
            f"({attempt['tail']!r}). {_preflight_summary(preflight)}.")
        _MET_ACQ_SECONDS.observe(elapsed, outcome="error")
    _MET_ACQ_FAILURES.inc(phase=last if last in ACQUIRE_PHASES
                          else "(none)")
    if event_sink is not None:
        try:
            event_sink("backend_degraded", "critical",
                       f"acquisition {attempt['outcome']} in phase "
                       f"{last!r} after {elapsed}s; no card, and the port "
                       f"does not fall back to the CPU "
                       f"({_preflight_summary(preflight)})")
        except Exception:
            pass  # a broken sink must never mask the diagnosis itself
    return {"acquired": False, "attempts": [attempt],
            "diagnosis": diagnosis, "phases": phases,
            "phase_stamps": stamps, "preflight": preflight,
            "last_phase": phases[-1] if phases else "",
            "stacks": stacks[-4000:]}


def ensure_device(device="cuda", timeout_s: float | None = None,
                  event_sink=None) -> dict:
    """The controller's boot path: acquire the card within
    ``timeout_s`` (default CRANE_ACQUIRE_TIMEOUT, else
    ``DEFAULT_BOOT_TIMEOUT_S``) before the first cycle can touch it
    under the RPC lock.  ``device`` of type ``cpu`` has nothing to
    acquire."""
    import torch
    if torch.device(device).type == "cpu":
        return {"acquired": True, "platform": "cpu", "attempts": [],
                "note": "the CPU was asked for",
                "preflight": preflight_report()}
    if timeout_s is None:
        timeout_s = float(os.environ.get("CRANE_ACQUIRE_TIMEOUT",
                                         DEFAULT_BOOT_TIMEOUT_S))
    return acquire_device(timeout_s, event_sink=event_sink)
