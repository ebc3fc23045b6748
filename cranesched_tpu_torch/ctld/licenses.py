"""Cluster-wide consumable licenses (the port's copy of
``cranesched_tpu/ctld/licenses.py``).

Mirrors the reference's LicenseManager (reference:
src/CraneCtld/Accounting/LicenseManager.h:46-125 — local license
counts AND remote/server-synced ones, with a reserve→malloc→free
lifecycle checked inside the scheduling cycle;
CheckLicenseCountSufficient is called from NodeSelect,
JobScheduler.cpp:6739).

Remote licenses: a ``remote`` license's total and externally-consumed
seat count come from a license server, reconciled by a periodic sync
program (``LicenseSyncer`` — the lmstat-parsing role; any executable
printing ``name total used`` lines works).  The cycle's availability
math then subtracts BOTH this cluster's in-flight seats and the
server-reported external usage."""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass
class License:
    name: str
    total: int
    in_use: int = 0
    # remote (server-synced) license state: the sync loop owns total
    # and external_used; in_use stays THIS cluster's seats.
    # external_used should exclude this cluster's own checkouts (the
    # sync program's responsibility); when it cannot, the overlap
    # double-counts — the conservative direction.
    remote: bool = False
    external_used: int = 0

    @property
    def free(self) -> int:
        return self.total - self.in_use - self.external_used


class LicenseManager:
    def __init__(self):
        self.licenses: dict[str, License] = {}
        # bumped whenever availability can have changed (configure /
        # sync / malloc / free / restore that actually moved a count) —
        # one term of the scheduler's no-op-cycle fingerprint
        self.epoch = 0

    def configure(self, name: str, total: int,
                  remote: bool = False) -> None:
        lic = self.licenses.get(name)
        if lic is None:
            self.licenses[name] = License(name=name, total=total,
                                          remote=remote)
            self.epoch += 1
        else:
            if lic.total != total or lic.remote != remote:
                self.epoch += 1
            lic.total = total
            lic.remote = remote

    def sync(self, observed: Mapping[str, tuple[int, int]]) -> None:
        """Reconcile remote licenses against a server observation:
        ``{name: (total, external_used)}``.  Local (non-remote)
        licenses and this cluster's own in_use are never touched; an
        unknown name is configured as a new remote license (the
        reference discovers server licenses the same way)."""
        for name, (total, used) in observed.items():
            lic = self.licenses.get(name)
            if lic is None:
                lic = self.licenses[name] = License(
                    name=name, total=int(total), remote=True)
                self.epoch += 1
            if not lic.remote:
                continue   # a local license shadows the server's name
            if (lic.total != int(total)
                    or lic.external_used != max(int(used), 0)):
                self.epoch += 1
            lic.total = int(total)
            lic.external_used = max(int(used), 0)

    def legal(self, wanted: Mapping[str, int] | None) -> str:
        """Submit-time legality (reference CheckLicensesLegal): every
        requested license exists and the count fits the TOTAL."""
        for name, count in (wanted or {}).items():
            lic = self.licenses.get(name)
            if lic is None:
                return f"unknown license {name}"
            if count > lic.total:
                return (f"license {name}: requested {count} "
                        f"> total {lic.total}")
        return ""

    def sufficient(self, wanted: Mapping[str, int] | None) -> bool:
        """Cycle-time availability (CheckLicenseCountSufficient)."""
        return all(count <= self.licenses[name].free
                   for name, count in (wanted or {}).items()
                   if name in self.licenses)

    def malloc(self, wanted: Mapping[str, int] | None) -> bool:
        """Atomically take all or none."""
        if not self.sufficient(wanted):
            return False
        for name, count in (wanted or {}).items():
            self.licenses[name].in_use += count
            if count:
                self.epoch += 1
        return True

    def restore(self, wanted: Mapping[str, int] | None) -> None:
        """Crash recovery: force-account seats a recovered running job
        already holds.  May push in_use past total (e.g. totals lowered
        between restarts) — sufficient() then admits nothing new until
        the overcommit drains, which is the safe direction."""
        for name, count in (wanted or {}).items():
            lic = self.licenses.get(name)
            if lic is not None and count:
                lic.in_use += count
                self.epoch += 1

    def free(self, wanted: Mapping[str, int] | None) -> None:
        for name, count in (wanted or {}).items():
            lic = self.licenses.get(name)
            if lic is not None and lic.in_use > 0 and count:
                lic.in_use = max(lic.in_use - count, 0)
                self.epoch += 1


class LicenseSyncer:
    """Periodic remote-license reconciliation (the reference's
    server-synced mode, LicenseManager.h:46-125).  Runs ``program``
    (bash -c) every ``interval`` seconds and feeds its stdout —
    ``name total used`` per line — into ``manager.sync`` under the
    given lock (the ctld server lock: totals must not move mid-cycle).
    A failing or garbled run changes nothing (the last observation
    stands, which is the only sane failure mode for a license
    server blip)."""

    def __init__(self, manager: LicenseManager, program: str,
                 interval: float = 60.0, lock=None):
        self.manager = manager
        self.program = program
        self.interval = interval
        self.lock = lock
        self.last_sync: float | None = None
        self.last_error = ""
        self._stop = None

    @staticmethod
    def parse(text: str) -> dict[str, tuple[int, int]]:
        observed = {}
        for line in text.splitlines():
            parts = line.split()
            if len(parts) != 3 or parts[0].startswith("#"):
                continue
            try:
                observed[parts[0]] = (int(parts[1]), int(parts[2]))
            except ValueError:
                continue
        return observed

    def sync_once(self) -> bool:
        import subprocess
        import time as _time
        try:
            result = subprocess.run(
                ["bash", "-c", self.program], capture_output=True,
                text=True, timeout=55)
        except (OSError, subprocess.SubprocessError) as exc:
            self.last_error = str(exc)[:200]
            return False
        if result.returncode != 0:
            self.last_error = (result.stderr or "nonzero exit")[:200]
            return False
        observed = self.parse(result.stdout)
        if not observed:
            self.last_error = "sync program produced no license lines"
            return False
        if self.lock is not None:
            with self.lock:
                self.manager.sync(observed)
        else:
            self.manager.sync(observed)
        self.last_sync = _time.time()
        self.last_error = ""
        return True

    def start(self) -> None:
        import threading
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.interval):
                self.sync_once()

        threading.Thread(target=loop, daemon=True).start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
