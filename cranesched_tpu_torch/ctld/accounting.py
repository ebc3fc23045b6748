"""Accounts, users, QoS: hierarchy, RBAC, and runtime limit enforcement
(the port's copy of ``cranesched_tpu/ctld/accounting.py``).

Counterpart of the reference's accounting stack (reference:
src/CraneCtld/Account/AccountManager.h:33-445 — hierarchical accounts/
users/QoS CRUD with admin levels None/Operator/Admin/Root and coordinator
permissions, AccountDefs.h:180-290 — and
src/CraneCtld/Accounting/AccountMetaContainer.h:70-265 — the runtime
usage ledger that enforces submit-time limits (MaxSubmitJobs per user/
account/qos) and schedule-time limits (MaxJobs, MaxTresPerUser/Account,
MaxWall) inside the scheduling cycle).

Host-side plain Python: this is control-plane bookkeeping consulted at
submit and commit time, not per-(job × node) math — the device solve
stays unaware of it (two-phase: the host ledger is authoritative, the
same split the reference uses between NodeSelect and
CheckAndMallocMetaResource, JobScheduler.cpp:1557-1573)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

import numpy as np

from cranesched_tpu_torch.ctld.defs import JobSpec
from cranesched_tpu_torch.ops.resources import ResourceLayout

UNLIMITED = 2**32 - 1  # matches the reference's uint32 "no limit"


class AdminLevel(enum.IntEnum):
    """Reference User::AdminLevel (AccountDefs.h:220): same-level users
    cannot control each other; higher controls lower."""

    NONE = 0
    OPERATOR = 1
    ADMIN = 2
    ROOT = 3


@dataclasses.dataclass
class Qos:
    """Reference Qos (AccountDefs.h:27-58)."""

    name: str
    description: str = ""
    priority: int = 0
    max_jobs_per_user: int = UNLIMITED
    max_jobs_per_account: int = UNLIMITED
    max_submit_jobs_per_user: int = UNLIMITED
    max_submit_jobs_per_account: int = UNLIMITED
    max_jobs: int = UNLIMITED
    max_submit_jobs: int = UNLIMITED
    max_wall: int = UNLIMITED            # seconds
    max_time_limit_per_job: int = UNLIMITED
    max_cpus_per_user: float = float("inf")
    max_tres: np.ndarray | None = None             # total in-flight
    max_tres_per_user: np.ndarray | None = None
    max_tres_per_account: np.ndarray | None = None
    # QoS names this QoS may preempt (reference Qos.preempt set)
    preempt: set[str] = dataclasses.field(default_factory=set)
    reference_count: int = 0


@dataclasses.dataclass
class Account:
    """Reference Account (AccountDefs.h:180)."""

    name: str
    parent: str | None = None
    description: str = ""
    users: set[str] = dataclasses.field(default_factory=set)
    child_accounts: set[str] = dataclasses.field(default_factory=set)
    allowed_partitions: set[str] | None = None     # None = all
    allowed_qos: set[str] = dataclasses.field(default_factory=set)
    default_qos: str = ""
    coordinators: set[str] = dataclasses.field(default_factory=set)
    blocked: bool = False


@dataclasses.dataclass
class UserAccountAttrs:
    """Reference User::AttrsInAccount (AccountDefs.h:235)."""

    allowed_partitions: set[str] | None = None     # None = inherit account
    blocked: bool = False


@dataclasses.dataclass
class User:
    """Reference User (AccountDefs.h:208)."""

    name: str
    uid: int = 0
    default_account: str = ""
    accounts: dict[str, UserAccountAttrs] = dataclasses.field(
        default_factory=dict)
    admin_level: AdminLevel = AdminLevel.NONE


class AccountingError(Exception):
    pass


class AccountManager:
    """Hierarchical account/user/QoS registry + permission checks
    (reference AccountManager.h — CheckUserPermissionToPartition :120s,
    CheckQosLimitOnJob, coordinator/admin RBAC)."""

    def __init__(self):
        self.accounts: dict[str, Account] = {}
        self.users: dict[str, User] = {}
        self.qos: dict[str, Qos] = {}
        self.txn_log: list[dict] = []   # audit (reference Txn,
                                        # AccountDefs.h:345)

    def _txn(self, actor: str, action: str, target: str) -> None:
        self.txn_log.append(dict(actor=actor, action=action, target=target))

    # ---- RBAC ----

    def _level(self, actor: str) -> AdminLevel:
        user = self.users.get(actor)
        return user.admin_level if user else AdminLevel.NONE

    def has_admin(self, actor: str,
                  needed: AdminLevel = AdminLevel.OPERATOR) -> bool:
        return self._level(actor) >= needed

    def is_coordinator(self, actor: str, account: str) -> bool:
        """Coordinators manage their account subtree."""
        acc = self.accounts.get(account)
        while acc is not None:
            if actor in acc.coordinators:
                return True
            acc = self.accounts.get(acc.parent) if acc.parent else None
        return False

    def can_manage(self, actor: str, account: str) -> bool:
        return self.has_admin(actor) or self.is_coordinator(actor, account)

    # ---- QoS CRUD ----

    def add_qos(self, actor: str, qos: Qos) -> None:
        if not self.has_admin(actor):
            raise AccountingError("permission denied")
        if qos.name in self.qos:
            raise AccountingError(f"qos {qos.name} exists")
        self.qos[qos.name] = qos
        self._txn(actor, "add_qos", qos.name)

    def delete_qos(self, actor: str, name: str) -> None:
        if not self.has_admin(actor):
            raise AccountingError("permission denied")
        q = self.qos.get(name)
        if q is None:
            raise AccountingError(f"qos {name} not found")
        if q.reference_count > 0:
            raise AccountingError(f"qos {name} is in use")
        del self.qos[name]
        self._txn(actor, "delete_qos", name)

    def modify_qos(self, actor: str, name: str, **fields) -> None:
        if not self.has_admin(actor):
            raise AccountingError("permission denied")
        q = self.qos.get(name)
        if q is None:
            raise AccountingError(f"qos {name} not found")
        for k, v in fields.items():
            if not hasattr(q, k):
                raise AccountingError(f"qos has no field {k}")
            setattr(q, k, v)
        self._txn(actor, "modify_qos", name)

    # ---- account CRUD ----

    def add_account(self, actor: str, account: Account) -> None:
        if not self.has_admin(actor):
            raise AccountingError("permission denied")
        if account.name in self.accounts:
            raise AccountingError(f"account {account.name} exists")
        if account.parent is not None:
            parent = self.accounts.get(account.parent)
            if parent is None:
                raise AccountingError(
                    f"parent account {account.parent} not found")
            parent.child_accounts.add(account.name)
        for q in account.allowed_qos:
            if q not in self.qos:
                raise AccountingError(f"qos {q} not found")
            self.qos[q].reference_count += 1
        self.accounts[account.name] = account
        self._txn(actor, "add_account", account.name)

    def delete_account(self, actor: str, name: str) -> None:
        if not self.has_admin(actor):
            raise AccountingError("permission denied")
        acc = self.accounts.get(name)
        if acc is None:
            raise AccountingError(f"account {name} not found")
        if acc.child_accounts or acc.users:
            raise AccountingError(f"account {name} is not empty")
        if acc.parent and acc.parent in self.accounts:
            self.accounts[acc.parent].child_accounts.discard(name)
        for q in acc.allowed_qos:
            if q in self.qos:
                self.qos[q].reference_count -= 1
        del self.accounts[name]
        self._txn(actor, "delete_account", name)

    def block_account(self, actor: str, name: str,
                      blocked: bool = True) -> None:
        if not self.can_manage(actor, name):
            raise AccountingError("permission denied")
        if name not in self.accounts:
            raise AccountingError(f"account {name} not found")
        self.accounts[name].blocked = blocked
        self._txn(actor, "block_account", name)

    # ---- user CRUD ----

    def add_user(self, actor: str, user: User, account: str) -> None:
        if not self.can_manage(actor, account):
            raise AccountingError("permission denied")
        acc = self.accounts.get(account)
        if acc is None:
            raise AccountingError(f"account {account} not found")
        existing = self.users.setdefault(user.name, user)
        existing.accounts.setdefault(account, UserAccountAttrs())
        if not existing.default_account:
            existing.default_account = account
        acc.users.add(user.name)
        self._txn(actor, "add_user", f"{user.name}@{account}")

    def remove_user(self, actor: str, name: str, account: str) -> None:
        if not self.can_manage(actor, account):
            raise AccountingError("permission denied")
        user = self.users.get(name)
        if user is None or account not in user.accounts:
            raise AccountingError(f"user {name} not in {account}")
        del user.accounts[account]
        self.accounts[account].users.discard(name)
        self._txn(actor, "remove_user", f"{name}@{account}")

    def set_admin_level(self, actor: str, name: str,
                        level: AdminLevel) -> None:
        # users with the same level cannot control each other
        # (AccountDefs.h:212-219)
        target = self.users.get(name)
        if target is None:
            raise AccountingError(f"user {name} not found")
        if self._level(actor) <= max(target.admin_level, level) and \
                self._level(actor) < AdminLevel.ROOT:
            raise AccountingError("permission denied")
        target.admin_level = level
        self._txn(actor, "set_admin_level", f"{name}={level.name}")

    def block_user(self, actor: str, name: str, account: str,
                   blocked: bool = True) -> None:
        if not self.can_manage(actor, account):
            raise AccountingError("permission denied")
        user = self.users.get(name)
        if user is None or account not in user.accounts:
            raise AccountingError(f"user {name} not in {account}")
        user.accounts[account].blocked = blocked
        self._txn(actor, "block_user", f"{name}@{account}")

    # ---- submit-time resolution (reference CheckUserPermission... +
    #      qos resolution in AcquireJobAttributes) ----

    def resolve_submit(self, user_name: str, account_name: str,
                       partition: str, qos_name: str | None
                       ) -> tuple[Qos | None, str]:
        """Returns (qos, error).  qos None + error "" means accounting is
        not configured for this user (open system, reference behavior
        with no accounting DB)."""
        if not self.users and not self.accounts:
            return None, ""              # accounting disabled
        user = self.users.get(user_name)
        if user is None:
            return None, f"user {user_name} unknown"
        attrs = user.accounts.get(account_name)
        if attrs is None:
            return None, f"user {user_name} not in account {account_name}"
        if attrs.blocked:
            return None, f"user {user_name} blocked in {account_name}"
        acc = self.accounts.get(account_name)
        if acc is None:
            return None, f"account {account_name} unknown"
        if acc.blocked:
            return None, f"account {account_name} blocked"
        allowed_parts = (attrs.allowed_partitions
                         if attrs.allowed_partitions is not None
                         else acc.allowed_partitions)
        if allowed_parts is not None and partition not in allowed_parts:
            return None, (f"partition {partition} not allowed for "
                          f"{user_name}@{account_name}")
        name = qos_name or acc.default_qos
        if not name:
            return None, ""              # no qos configured
        if acc.allowed_qos and name not in acc.allowed_qos:
            return None, f"qos {name} not allowed for {account_name}"
        qos = self.qos.get(name)
        if qos is None:
            return None, f"qos {name} unknown"
        return qos, ""


@dataclasses.dataclass
class _Usage:
    jobs: int = 0          # running
    submit_jobs: int = 0   # pending + running
    tres: np.ndarray | None = None

    def tres_vec(self, dims: int) -> np.ndarray:
        if self.tres is None:
            self.tres = np.zeros(dims, np.int64)
        return self.tres


class AccountMetaContainer:
    """Runtime usage ledger + limit enforcement (reference
    AccountMetaContainer.h:70-265: TryMallocMetaSubmitResource :86 at
    submit, CheckAndMallocMetaResource :113 at schedule commit,
    CheckRunLimits_ :239)."""

    def __init__(self, layout: ResourceLayout | None = None):
        self.layout = layout or ResourceLayout()
        self._qos: dict[str, _Usage] = {}
        self._user: dict[tuple[str, str], _Usage] = {}   # (qos, user)
        self._acct: dict[tuple[str, str], _Usage] = {}   # (qos, account)

    def _u(self, d, key) -> _Usage:
        if key not in d:
            d[key] = _Usage()
        return d[key]

    @staticmethod
    def _job_tres(spec: JobSpec, layout: ResourceLayout) -> np.ndarray:
        per_node = spec.res.encode(layout).astype(np.int64)
        if spec.task_res is not None:
            ntasks = spec.ntasks or spec.node_num
            return (per_node * spec.node_num
                    + spec.task_res.encode(layout).astype(np.int64)
                    * ntasks)
        return per_node * spec.node_num

    # ---- submit-time (TryMallocMetaSubmitResource) ----

    def try_malloc_submit(self, user: str, account: str, qos: Qos,
                          spec: JobSpec) -> str:
        """Returns "" on success (slots taken), else the refusal reason."""
        if spec.time_limit > qos.max_time_limit_per_job:
            return "time limit exceeds qos MaxTimeLimitPerJob"
        if spec.time_limit > qos.max_wall:
            return "time limit exceeds qos MaxWall"
        uq = self._u(self._user, (qos.name, user))
        aq = self._u(self._acct, (qos.name, account))
        qq = self._u(self._qos, qos.name)
        if uq.submit_jobs >= qos.max_submit_jobs_per_user:
            return "qos MaxSubmitJobsPerUser reached"
        if aq.submit_jobs >= qos.max_submit_jobs_per_account:
            return "qos MaxSubmitJobsPerAccount reached"
        if qq.submit_jobs >= qos.max_submit_jobs:
            return "qos MaxSubmitJobs reached"
        uq.submit_jobs += 1
        aq.submit_jobs += 1
        qq.submit_jobs += 1
        return ""

    def free_submit(self, user: str, account: str, qos_name: str) -> None:
        for usage in (self._user.get((qos_name, user)),
                      self._acct.get((qos_name, account)),
                      self._qos.get(qos_name)):
            if usage is not None and usage.submit_jobs > 0:
                usage.submit_jobs -= 1

    # ---- schedule-time (CheckAndMallocMetaResource / CheckRunLimits_) ----

    def check_and_malloc_run(self, user: str, account: str, qos: Qos,
                             spec: JobSpec) -> str:
        """Returns "" on success (run usage taken), else the reason."""
        dims = self.layout.num_dims
        tres = self._job_tres(spec, self.layout)
        uq = self._u(self._user, (qos.name, user))
        aq = self._u(self._acct, (qos.name, account))
        qq = self._u(self._qos, qos.name)
        if uq.jobs >= qos.max_jobs_per_user:
            return "qos MaxJobsPerUser reached"
        if aq.jobs >= qos.max_jobs_per_account:
            return "qos MaxJobsPerAccount reached"
        if qq.jobs >= qos.max_jobs:
            return "qos MaxJobs reached"
        from cranesched_tpu_torch.ops.resources import CPU_SCALE, DIM_CPU
        if (uq.tres_vec(dims)[DIM_CPU] + tres[DIM_CPU]) / CPU_SCALE > \
                qos.max_cpus_per_user:
            return "qos MaxCpusPerUser reached"
        if qos.max_tres_per_user is not None and np.any(
                uq.tres_vec(dims) + tres > qos.max_tres_per_user):
            return "qos MaxTresPerUser reached"
        if qos.max_tres_per_account is not None and np.any(
                aq.tres_vec(dims) + tres > qos.max_tres_per_account):
            return "qos MaxTresPerAccount reached"
        if qos.max_tres is not None and np.any(
                qq.tres_vec(dims) + tres > qos.max_tres):
            return "qos MaxTres reached"
        for usage in (uq, aq, qq):
            usage.jobs += 1
            usage.tres_vec(dims)[:] += tres
        return ""

    # ---- crash recovery: usage is derived state, rebuilt from the WAL
    #      replay without re-running the checks (the slots were already
    #      granted before the crash) ----

    def restore_submit(self, user: str, account: str,
                       qos_name: str) -> None:
        for usage in (self._u(self._user, (qos_name, user)),
                      self._u(self._acct, (qos_name, account)),
                      self._u(self._qos, qos_name)):
            usage.submit_jobs += 1

    def restore_run(self, user: str, account: str, qos_name: str,
                    spec: JobSpec) -> None:
        tres = self._job_tres(spec, self.layout)
        dims = self.layout.num_dims
        for usage in (self._u(self._user, (qos_name, user)),
                      self._u(self._acct, (qos_name, account)),
                      self._u(self._qos, qos_name)):
            usage.jobs += 1
            usage.tres_vec(dims)[:] += tres

    def free_run(self, user: str, account: str, qos_name: str,
                 spec: JobSpec) -> None:
        tres = self._job_tres(spec, self.layout)
        dims = self.layout.num_dims
        for usage in (self._user.get((qos_name, user)),
                      self._acct.get((qos_name, account)),
                      self._qos.get(qos_name)):
            if usage is not None and usage.jobs > 0:
                usage.jobs -= 1
                usage.tres_vec(dims)[:] = np.maximum(
                    usage.tres_vec(dims) - tres, 0)
