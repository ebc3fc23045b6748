"""Durable accounting: accounts/users/QoS/txn-log in sqlite (the port's
copy of ``cranesched_tpu/ctld/acct_store.py``).

The reference persists the whole accounting hierarchy in MongoDB
(reference: src/CraneCtld/Database/DbClient.h:87-724 — user/account/qos
collections plus the Txn audit log) and rebuilds AccountManager from it
on boot, so a restart keeps every account, user, QoS and audit row that
the WAL's jobs refer to.  The same pattern as ctld/archive.py: one
sqlite file, entity rows as JSON records, synced after every successful
mutation (accounting CRUD is rare admin-path work, so a full-entity
sync per mutation is cheap and leaves no partial-write states).

Boot order matters: the store loads BEFORE WAL replay so that
``JobScheduler.recover`` can re-take QoS usage (restore_submit /
restore_run) against the restored hierarchy.
"""

from __future__ import annotations

import json
import sqlite3
import threading

import numpy as np

from cranesched_tpu_torch.ctld.accounting import (
    Account,
    AccountManager,
    AdminLevel,
    Qos,
    User,
    UserAccountAttrs,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS qos      (name TEXT PRIMARY KEY,
                                     record TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS accounts (name TEXT PRIMARY KEY,
                                     record TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS users    (name TEXT PRIMARY KEY,
                                     record TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS txns    (seq INTEGER PRIMARY KEY AUTOINCREMENT,
                                    actor TEXT, action TEXT, target TEXT);
"""


def _arr(x):
    return None if x is None else np.asarray(x).tolist()


def _unarr(x):
    return None if x is None else np.asarray(x, np.int64)


def _qos_to_dict(q: Qos) -> dict:
    d = {
        "name": q.name, "description": q.description,
        "priority": q.priority,
        "max_jobs_per_user": q.max_jobs_per_user,
        "max_jobs_per_account": q.max_jobs_per_account,
        "max_submit_jobs_per_user": q.max_submit_jobs_per_user,
        "max_submit_jobs_per_account": q.max_submit_jobs_per_account,
        "max_jobs": q.max_jobs, "max_submit_jobs": q.max_submit_jobs,
        "max_wall": q.max_wall,
        "max_time_limit_per_job": q.max_time_limit_per_job,
        "max_cpus_per_user": (None if q.max_cpus_per_user == float("inf")
                              else q.max_cpus_per_user),
        "max_tres": _arr(q.max_tres),
        "max_tres_per_user": _arr(q.max_tres_per_user),
        "max_tres_per_account": _arr(q.max_tres_per_account),
        "preempt": sorted(q.preempt),
        "reference_count": q.reference_count,
    }
    return d


def _qos_from_dict(d: dict) -> Qos:
    return Qos(
        name=d["name"], description=d.get("description", ""),
        priority=d.get("priority", 0),
        max_jobs_per_user=d["max_jobs_per_user"],
        max_jobs_per_account=d["max_jobs_per_account"],
        max_submit_jobs_per_user=d["max_submit_jobs_per_user"],
        max_submit_jobs_per_account=d["max_submit_jobs_per_account"],
        max_jobs=d["max_jobs"], max_submit_jobs=d["max_submit_jobs"],
        max_wall=d["max_wall"],
        max_time_limit_per_job=d["max_time_limit_per_job"],
        max_cpus_per_user=(float("inf")
                           if d.get("max_cpus_per_user") is None
                           else d["max_cpus_per_user"]),
        max_tres=_unarr(d.get("max_tres")),
        max_tres_per_user=_unarr(d.get("max_tres_per_user")),
        max_tres_per_account=_unarr(d.get("max_tres_per_account")),
        preempt=set(d.get("preempt", ())),
        reference_count=d.get("reference_count", 0))


def _account_to_dict(a: Account) -> dict:
    return {
        "name": a.name, "parent": a.parent,
        "description": a.description,
        "users": sorted(a.users),
        "child_accounts": sorted(a.child_accounts),
        "allowed_partitions": (None if a.allowed_partitions is None
                               else sorted(a.allowed_partitions)),
        "allowed_qos": sorted(a.allowed_qos),
        "default_qos": a.default_qos,
        "coordinators": sorted(a.coordinators),
        "blocked": a.blocked,
    }


def _account_from_dict(d: dict) -> Account:
    return Account(
        name=d["name"], parent=d.get("parent"),
        description=d.get("description", ""),
        users=set(d.get("users", ())),
        child_accounts=set(d.get("child_accounts", ())),
        allowed_partitions=(None if d.get("allowed_partitions") is None
                            else set(d["allowed_partitions"])),
        allowed_qos=set(d.get("allowed_qos", ())),
        default_qos=d.get("default_qos", ""),
        coordinators=set(d.get("coordinators", ())),
        blocked=d.get("blocked", False))


def _user_to_dict(u: User) -> dict:
    return {
        "name": u.name, "uid": u.uid,
        "default_account": u.default_account,
        "accounts": {
            name: {"allowed_partitions":
                   (None if attrs.allowed_partitions is None
                    else sorted(attrs.allowed_partitions)),
                   "blocked": attrs.blocked}
            for name, attrs in u.accounts.items()},
        "admin_level": int(u.admin_level),
    }


def _user_from_dict(d: dict) -> User:
    return User(
        name=d["name"], uid=d.get("uid", 0),
        default_account=d.get("default_account", ""),
        accounts={
            name: UserAccountAttrs(
                allowed_partitions=(None
                                    if a.get("allowed_partitions") is None
                                    else set(a["allowed_partitions"])),
                blocked=a.get("blocked", False))
            for name, a in d.get("accounts", {}).items()},
        admin_level=AdminLevel(d.get("admin_level", 0)))


class AccountStore:
    """sqlite persistence for the AccountManager (the MongoDB-collections
    analog).  ``sync`` rewrites the three entity tables to match the
    in-memory state inside one transaction; ``append_txn`` appends to the
    audit log."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(_SCHEMA)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    def sync(self, mgr: AccountManager) -> None:
        with self._lock:
            cur = self._db.cursor()
            for table, items, to_dict in (
                    ("qos", mgr.qos, _qos_to_dict),
                    ("accounts", mgr.accounts, _account_to_dict),
                    ("users", mgr.users, _user_to_dict)):
                cur.execute(f"DELETE FROM {table}")
                cur.executemany(
                    f"INSERT INTO {table} (name, record) VALUES (?, ?)",
                    [(name, json.dumps(to_dict(obj),
                                       separators=(",", ":")))
                     for name, obj in items.items()])
            self._db.commit()

    def append_txn(self, entry: dict) -> None:
        with self._lock:
            self._db.execute(
                "INSERT INTO txns (actor, action, target) "
                "VALUES (?, ?, ?)",
                (entry.get("actor", ""), entry.get("action", ""),
                 entry.get("target", "")))
            self._db.commit()

    def load_into(self, mgr: AccountManager) -> int:
        """Rebuild the manager's hierarchy + txn log from disk.  Returns
        the number of entities restored.  Rows loaded from disk replace
        same-named in-memory entries (config-seeded root users keep
        their entry unless the store knows better)."""
        n = 0
        with self._lock:
            for table, target, from_dict in (
                    ("qos", mgr.qos, _qos_from_dict),
                    ("accounts", mgr.accounts, _account_from_dict),
                    ("users", mgr.users, _user_from_dict)):
                for name, record in self._db.execute(
                        f"SELECT name, record FROM {table}"):
                    target[name] = from_dict(json.loads(record))
                    n += 1
            mgr.txn_log = [
                dict(actor=a, action=act, target=t)
                for a, act, t in self._db.execute(
                    "SELECT actor, action, target FROM txns "
                    "ORDER BY seq")]
        return n


def attach_store(mgr: AccountManager, store: AccountStore) -> int:
    """Load the store into the manager and arrange for every subsequent
    successful mutation to persist (every mutating AccountManager method
    records a txn as its last step, so hooking ``_txn`` is exactly the
    commit point)."""
    restored = store.load_into(mgr)
    plain_txn = mgr._txn

    def txn_and_persist(actor: str, action: str, target: str) -> None:
        plain_txn(actor, action, target)
        store.append_txn(dict(actor=actor, action=action, target=target))
        store.sync(mgr)

    mgr._txn = txn_and_persist
    mgr.store = store
    return restored
