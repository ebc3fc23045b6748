"""Cgroup v1 + v2 management for job steps.

The capability counterpart of the reference's CgroupManager (reference:
src/Craned/Common/CgroupManager.h:403-530 — a CgroupV1/CgroupV2
abstraction with cpu quota, cpuset pinning, memory limits, freezer,
device ACLs, and a job/step hierarchy).  Both backends implement the
same surface under an injectable root, so tests run against a fake
cgroupfs tree and unprivileged environments degrade to a clean no-op:

* ``CgroupV2`` — the unified hierarchy controller files (cpu.max,
  memory.max, memory.swap.max, cpuset.cpus, cgroup.freeze,
  cgroup.kill).
* ``CgroupV1`` — split hierarchies (cpu/, memory/, freezer/, cpuset/,
  devices/), one job directory per controller.  This is where GRES
  isolation becomes ENFORCED: the v1 ``devices`` controller
  (devices.deny/devices.allow) gates device nodes in the kernel, the
  moral equivalent of the reference's v1 path (CgroupManager.h:438;
  its v2 equivalent is the eBPF program src/Misc/BPF/
  cgroup_dev_bpf.c:12-40).

Enforcement gap, documented: on a pure-v2 host the device ACL needs
that eBPF program (BPF_PROG_TYPE_CGROUP_DEVICE); this build has no BPF
toolchain, so v2 deployments get cpuset pinning + vendor-env scoping
but no kernel device gate.  ``supports_devices`` tells the daemon
which world it is in.

Teardown kills before it removes (reference destroy semantics): v2
writes ``cgroup.kill``, v1 SIGKILLs every pid in ``cgroup.procs``,
both retry the rmdir — a stuck step does not leak its cgroup
silently.

The port's copy of ``cranesched_tpu/craned/cgroup.py``,
with the port's imports.
"""

from __future__ import annotations

import os
import signal
import time

CPU_PERIOD = 100_000  # standard cgroup period (µs)

# device-ACL default whitelist when deny-all is in force: the standard
# "plumbing" nodes every job needs (null, zero, full, random, urandom,
# tty, ptmx, pts/*) — the same spirit as the reference's base rules
DEFAULT_DEVICE_RULES = (
    "c 1:3 rwm", "c 1:5 rwm", "c 1:7 rwm", "c 1:8 rwm", "c 1:9 rwm",
    "c 5:0 rwm", "c 5:2 rwm", "c 136:* rwm",
)


def write_pid_to_cgroup(procs_path, pid: int) -> bool:
    """Attach ``pid`` to a job's cgroup(s): one cgroup.procs path for
    v2, a list (one per controller hierarchy) for v1.  Best-effort by
    contract — callers run where cgroups may be absent entirely.
    Returns True when the pid landed in at least one hierarchy; False
    means NO containment happened (no paths, or every write failed) so
    callers can surface the gap instead of silently proceeding."""
    attached = False
    for pp in ([procs_path] if isinstance(procs_path, str)
               else procs_path or []):
        try:
            with open(pp, "w") as fh:
                fh.write(str(pid))
            attached = True
        except OSError:
            pass
    return attached


def _kill_pids(procs_file: str) -> bool:
    """SIGKILL everything listed in a cgroup.procs file; True if the
    file was readable (regardless of whether anything lived)."""
    try:
        with open(procs_file) as fh:
            pids = [int(p) for p in fh.read().split()]
    except (OSError, ValueError):
        return False
    me = os.getpid()
    for pid in pids:
        # a procs file can name this very process (PAM ADOPT takes any
        # caller-supplied pid, and in-process daemons share the test
        # runner's pid) — cgroup teardown must never be suicide
        if pid <= 1 or pid == me:
            continue
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    return True


def _remove_dir(d: str, procs_file: str | None = None,
                kill_file: str | None = None,
                retries: int = 20, interval: float = 0.05) -> bool:
    """Kill-then-rmdir with retries.  A cgroup directory refuses rmdir
    while member processes live; zombies can linger briefly after
    SIGKILL, hence the bounded retry loop."""
    if not os.path.isdir(d):
        return True
    killed_via_file = False
    for attempt in range(retries):
        if kill_file is not None:
            # one write suffices (it kills the whole subtree); retries
            # below only wait out zombie reaping
            try:
                with open(kill_file, "w") as fh:
                    fh.write("1")
                killed_via_file = True
            except OSError:
                pass  # pre-5.14 kernel: fall back to pids
            kill_file = None
        if not killed_via_file and procs_file is not None:
            _kill_pids(procs_file)
        try:
            os.rmdir(d)
            return True
        except OSError:
            # container runtimes create CHILD cgroups under the job
            # cgroup (--cgroup-parent=crane/job_<id>), so teardown
            # must kill-then-rmdir bottom-up or destroy() exhausts its
            # retries and leaks the job cgroup whenever it races
            # container removal.  Fake cgroupfs trees (tests) also
            # hold regular files that, on a real kernel, vanish with
            # the directory; drop them and retry at once so the
            # common case pays no sleep (kernel controller files
            # refuse unlink — ignored)
            for name in os.listdir(d) if os.path.isdir(d) else ():
                path = os.path.join(d, name)
                if os.path.isdir(path):
                    child_procs = os.path.join(path, "cgroup.procs")
                    child_kill = os.path.join(path, "cgroup.kill")
                    _remove_dir(
                        path,
                        procs_file=(child_procs
                                    if os.path.exists(child_procs)
                                    else None),
                        kill_file=(child_kill
                                   if os.path.exists(child_kill)
                                   else None),
                        retries=2, interval=interval)
                    continue
                try:
                    os.unlink(path)
                except OSError:
                    pass
            try:
                os.rmdir(d)
                return True
            except OSError:
                time.sleep(interval)
    return False


class CgroupV2:
    """Job-level cgroups under <root>/crane/job_<id> (unified
    hierarchy)."""

    version = 2

    def __init__(self, root: str = "/sys/fs/cgroup"):
        self.root = root
        self.base = os.path.join(root, "crane")
        self.enabled = os.path.isdir(root) and os.access(root, os.W_OK)
        # no eBPF loader in this build: v2 cannot gate device nodes
        # (the documented enforcement gap)
        self.supports_devices = False
        self.supports_cpuset = True
        if self.enabled:
            try:
                os.makedirs(self.base, exist_ok=True)
            except OSError:
                self.enabled = False

    def _dir(self, job_id: int) -> str:
        return os.path.join(self.base, f"job_{job_id}")

    def _write(self, job_id: int, ctl: str, value: str) -> bool:
        try:
            with open(os.path.join(self._dir(job_id), ctl), "w") as fh:
                fh.write(value)
            return True
        except OSError:
            return False

    def create(self, job_id: int, cpu: float = 0.0, mem_bytes: int = 0,
               memsw_bytes: int = 0, cpuset_cpus: str = "",
               allow_devices: tuple[str, ...] | None = None
               ) -> list[str] | None:
        """Create the job cgroup with limits; returns the cgroup.procs
        path(s) for the supervisor to attach the step, or None when
        cgroups are unavailable.  ``allow_devices`` is accepted for
        interface parity but unenforceable on v2 here (see module
        docstring)."""
        if not self.enabled:
            return None
        d = self._dir(job_id)
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            return None
        if cpu > 0:
            self._write(job_id, "cpu.max",
                        f"{int(cpu * CPU_PERIOD)} {CPU_PERIOD}")
        if mem_bytes > 0:
            self._write(job_id, "memory.max", str(int(mem_bytes)))
        if memsw_bytes > mem_bytes > 0:
            self._write(job_id, "memory.swap.max",
                        str(int(memsw_bytes - mem_bytes)))
        if cpuset_cpus:
            self._write(job_id, "cpuset.cpus", cpuset_cpus)
        return [os.path.join(d, "cgroup.procs")]

    def freeze(self, job_id: int, frozen: bool) -> bool:
        """The v2 freezer (reference suspend path: cgroup freezer keeps
        the process image, JobManager.h:150)."""
        return self._write(job_id, "cgroup.freeze",
                           "1" if frozen else "0")

    def destroy(self, job_id: int) -> bool:
        d = self._dir(job_id)
        return _remove_dir(d,
                           procs_file=os.path.join(d, "cgroup.procs"),
                           kill_file=os.path.join(d, "cgroup.kill"))


class CgroupV1:
    """Split-hierarchy cgroups: <root>/<controller>/crane/job_<id> per
    controller (reference CgroupV1, CgroupManager.h:438)."""

    version = 1
    # controller -> required for ``enabled`` (cpu/memory are the core
    # resource limits; the rest degrade individually)
    CONTROLLERS = ("cpu", "memory", "freezer", "cpuset", "devices")

    def __init__(self, root: str = "/sys/fs/cgroup"):
        self.root = root
        self._avail = {
            c: os.path.isdir(os.path.join(root, c))
            and os.access(os.path.join(root, c), os.W_OK)
            for c in self.CONTROLLERS}
        self.enabled = self._avail["cpu"] or self._avail["memory"]
        self.supports_devices = self._avail["devices"]
        self.supports_cpuset = self._avail["cpuset"]
        if self._avail["cpuset"]:
            # the crane parent must hold cpus/mems before any child can
            # host processes (v1 cpuset starts empty, children must be
            # subsets of the parent)
            try:
                base = os.path.join(root, "cpuset", "crane")
                os.makedirs(base, exist_ok=True)
                for ctl in ("cpuset.cpus", "cpuset.mems"):
                    with open(os.path.join(root, "cpuset", ctl)) as fh:
                        top = fh.read().strip()
                    with open(os.path.join(base, ctl), "w") as fh:
                        fh.write(top or "0")
            except OSError:
                self._avail["cpuset"] = False
                self.supports_cpuset = False

    def _dir(self, controller: str, job_id: int) -> str:
        return os.path.join(self.root, controller, "crane",
                            f"job_{job_id}")

    def _write(self, controller: str, job_id: int, ctl: str,
               value: str) -> bool:
        try:
            with open(os.path.join(self._dir(controller, job_id), ctl),
                      "w") as fh:
                fh.write(value)
            return True
        except OSError:
            return False

    def _mkdir(self, controller: str, job_id: int) -> bool:
        if not self._avail.get(controller):
            return False
        try:
            os.makedirs(self._dir(controller, job_id), exist_ok=True)
            return True
        except OSError:
            return False

    def create(self, job_id: int, cpu: float = 0.0, mem_bytes: int = 0,
               memsw_bytes: int = 0, cpuset_cpus: str = "",
               allow_devices: tuple[str, ...] | None = None
               ) -> list[str] | None:
        """Create the job's per-controller cgroups; returns every
        controller's cgroup.procs path (the supervisor attaches to each
        — v1 hierarchies are independent).

        ``allow_devices``: "c MAJ:MIN rwm" rules for the job's GRES
        devices.  When the devices controller is live and the daemon
        passed a non-None tuple, the cgroup denies ALL device nodes
        except the default plumbing + these — the kernel-enforced GRES
        isolation (reference v1 devices path / v2 eBPF ACL,
        cgroup_dev_bpf.c:12-40).  None = no device ACL (nodes without
        a configured device map)."""
        if not self.enabled:
            return None
        procs: list[str] = []
        if self._mkdir("cpu", job_id):
            if cpu > 0:
                self._write("cpu", job_id, "cpu.cfs_period_us",
                            str(CPU_PERIOD))
                self._write("cpu", job_id, "cpu.cfs_quota_us",
                            str(int(cpu * CPU_PERIOD)))
            procs.append(os.path.join(self._dir("cpu", job_id),
                                      "cgroup.procs"))
        if self._mkdir("memory", job_id):
            if mem_bytes > 0:
                self._write("memory", job_id, "memory.limit_in_bytes",
                            str(int(mem_bytes)))
            if memsw_bytes > mem_bytes > 0:
                # memsw needs swap accounting; best-effort (absent file
                # = kernel without swapaccount=1)
                self._write("memory", job_id,
                            "memory.memsw.limit_in_bytes",
                            str(int(memsw_bytes)))
            procs.append(os.path.join(self._dir("memory", job_id),
                                      "cgroup.procs"))
        if self._mkdir("freezer", job_id):
            procs.append(os.path.join(self._dir("freezer", job_id),
                                      "cgroup.procs"))
        if cpuset_cpus and self._mkdir("cpuset", job_id):
            ok = self._write("cpuset", job_id, "cpuset.cpus",
                             cpuset_cpus)
            try:
                with open(os.path.join(self.root, "cpuset", "crane",
                                       "cpuset.mems")) as fh:
                    mems = fh.read().strip() or "0"
            except OSError:
                mems = "0"
            ok = self._write("cpuset", job_id, "cpuset.mems",
                             mems) and ok
            if ok:
                procs.append(os.path.join(self._dir("cpuset", job_id),
                                          "cgroup.procs"))
        if allow_devices is not None and self.supports_devices \
                and self._mkdir("devices", job_id):
            # deny-all, then re-allow the plumbing + the job's devices;
            # only attach to the controller if the deny actually landed
            # (a failed deny with an attach would be allow-all — worse
            # than no controller at all is fine, but lying isn't)
            if self._write("devices", job_id, "devices.deny", "a"):
                for rule in (*DEFAULT_DEVICE_RULES, *allow_devices):
                    self._write("devices", job_id, "devices.allow",
                                rule)
                procs.append(os.path.join(
                    self._dir("devices", job_id), "cgroup.procs"))
        return procs or None

    def freeze(self, job_id: int, frozen: bool) -> bool:
        return self._write("freezer", job_id, "freezer.state",
                           "FROZEN" if frozen else "THAWED")

    def destroy(self, job_id: int) -> bool:
        # thaw first: frozen tasks cannot run their SIGKILL
        self.freeze(job_id, False)
        ok = True
        for controller in self.CONTROLLERS:
            d = self._dir(controller, job_id)
            ok = _remove_dir(
                d, procs_file=os.path.join(d, "cgroup.procs")) and ok
        return ok


def make_cgroups(root: str = "/sys/fs/cgroup"):
    """Detect the hierarchy flavor at ``root``: the unified (v2) mount
    has cgroup.controllers at its top; a v1 mount is a directory of
    per-controller hierarchies.  Unavailable roots return a disabled
    CgroupV2 (clean no-op, as before)."""
    if os.path.isfile(os.path.join(root, "cgroup.controllers")):
        return CgroupV2(root)
    v1 = CgroupV1(root)
    if v1.enabled:
        return v1
    return CgroupV2(root)
