"""Request authentication + authorization for the ctld RPC surface.

The reference authenticates every external RPC with a per-user mTLS
certificate whose identity must match the claimed uid
(CheckCertAndUIDAllowed_, reference:
src/CraneCtld/RpcService/CtldGrpcServer.h:568, used at :698+; certs are
signed via Vault, AccountManager::SignUserCertificate
AccountManager.h:171), then authorizes via RBAC admin levels.

Here the minimum viable equivalent per VERDICT r2 #6: per-user bearer
tokens issued by ctld, carried as gRPC metadata (``crane-token``),
verified on every call; mutating RPCs require ownership or an admin
identity; the accounting actor is the AUTHENTICATED identity, never a
request field.

Hardening per ADVICE r3:

* The on-disk token table stores **SHA-256 hashes**, never plaintext —
  a leaked table file cannot be replayed.  Plaintext is returned exactly
  once at issuance.  The ctld's own bootstrap credentials (root + the
  legacy cluster secret) live in a separate 0600 keyring file so the
  daemon can keep using them across restarts.
* Craneds can hold **per-node identities** ``@craned/<name>`` (issued by
  an admin via ``issue_craned``); the server validates a node-bound RPC's
  ``node_id`` against the token's node name, so one compromised node can
  no longer impersonate the whole node plane.  The single shared
  ``@craned`` cluster secret remains supported for small/sim deployments
  (the documented residual risk).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading

CRANED_IDENTITY = "@craned"
TOKEN_METADATA_KEY = "crane-token"


def _th(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()


def craned_node_of(ident: str | None) -> str | None:
    """``@craned`` -> "*" (any node), ``@craned/<name>`` -> name,
    anything else -> None (not a craned identity)."""
    if ident is None:
        return None
    if ident == CRANED_IDENTITY:
        return "*"
    if ident.startswith(CRANED_IDENTITY + "/"):
        return ident[len(CRANED_IDENTITY) + 1:]
    return None


class AuthManager:
    """Token table + identity/authorization checks."""

    def __init__(self, token_file: str | None = None,
                 admins: tuple[str, ...] = ("root",),
                 accounts=None):
        self.token_file = token_file
        self.keyring_file = token_file + ".keyring" if token_file else None
        self.admins = set(admins) | {"root"}
        # AccountManager (optional): its RBAC admin levels also grant
        # admin here (reference: RBAC after cert check)
        self.accounts = accounts
        self._tokens: dict[str, str] = {}   # sha256(token) -> identity
        self._lock = threading.Lock()
        self.root_token = ""
        self.craned_token = ""
        self._recovered_legacy_creds = False
        self._load()
        self._bootstrap()

    # -- persistence --

    def _load(self) -> None:
        if self.keyring_file and os.path.exists(self.keyring_file):
            try:
                with open(self.keyring_file, encoding="utf-8") as fh:
                    keys = json.load(fh)
                self.root_token = keys.get("root", "")
                self.craned_token = keys.get("craned", "")
            except (OSError, json.JSONDecodeError, ValueError):
                pass
        if not self.token_file or not os.path.exists(self.token_file):
            return
        try:
            with open(self.token_file, encoding="utf-8") as fh:
                raw = dict(json.load(fh))
        except (OSError, json.JSONDecodeError, ValueError):
            return
        for key, ident in raw.items():
            if len(key) == 64 and all(c in "0123456789abcdef"
                                      for c in key):
                self._tokens[key] = ident
            else:
                # legacy plaintext row (pre-hashing table): convert, and
                # recover the daemon credentials into the keyring so a
                # restart keeps working
                self._tokens[_th(key)] = ident
                if ident == "root" and not self.root_token:
                    self.root_token = key
                    self._recovered_legacy_creds = True
                elif ident == CRANED_IDENTITY and not self.craned_token:
                    self.craned_token = key
                    self._recovered_legacy_creds = True

    def _save(self) -> None:
        if not self.token_file:
            return
        tmp = self.token_file + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(self._tokens, fh)
        os.replace(tmp, self.token_file)

    def _save_keyring(self) -> None:
        if not self.keyring_file:
            return
        tmp = self.keyring_file + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump({"root": self.root_token,
                       "craned": self.craned_token}, fh)
        os.replace(tmp, self.keyring_file)

    def _bootstrap(self) -> None:
        """Ensure a root token and the craned cluster secret exist."""
        with self._lock:
            changed = self._recovered_legacy_creds  # persist migrations
            if not self.root_token:
                self.root_token = secrets.token_urlsafe(24)
                changed = True
            if not self.craned_token:
                self.craned_token = secrets.token_urlsafe(24)
                changed = True
            self._tokens.setdefault(_th(self.root_token), "root")
            self._tokens.setdefault(_th(self.craned_token),
                                    CRANED_IDENTITY)
            self._save()
            if changed:
                self._save_keyring()

    # -- identity --

    def identity(self, metadata) -> str | None:
        """Map the request's token metadata to an identity; None =
        unauthenticated."""
        token = None
        for key, value in metadata or ():
            if key == TOKEN_METADATA_KEY:
                token = value
                break
        if not token:
            return None
        with self._lock:
            return self._tokens.get(_th(token))

    # -- authorization --

    def is_admin(self, user: str | None) -> bool:
        if user is None:
            return False
        if user in self.admins:
            return True
        if self.accounts is not None:
            from cranesched_tpu_torch.ctld.accounting import AdminLevel
            rec = self.accounts.users.get(user)
            if rec is not None and rec.admin_level >= AdminLevel.OPERATOR:
                return True
        return False

    def may_act_on_job(self, user: str | None, job) -> bool:
        """Owner-or-admin rule for job mutations (cancel/hold/suspend/
        steps/free)."""
        if user is None:
            return False
        return user == job.spec.user or self.is_admin(user)

    # -- issuance --

    def issue(self, actor: str | None, user: str) -> str | None:
        """Admin-only token issuance (the SignUserCertificate analog).
        The plaintext is returned exactly once; only its hash persists."""
        if not self.is_admin(actor):
            return None
        token = secrets.token_urlsafe(24)
        with self._lock:
            self._tokens[_th(token)] = user
            self._save()
        return token

    def issue_craned(self, actor: str | None, node_name: str
                     ) -> str | None:
        """Admin-only per-node craned token (identity
        ``@craned/<name>``); the server binds node-scoped RPCs to it."""
        if not self.is_admin(actor):
            return None
        return self.issue(actor, f"{CRANED_IDENTITY}/{node_name}")

    def revoke(self, actor: str | None, user: str) -> int:
        """Admin-only: drop every token of ``user`` (RevokeCert analog).
        Returns the number revoked.

        Revoking the bootstrap identities (``root`` / ``@craned``)
        additionally ROTATES the keyring credential — without that, the
        old plaintext still sits in the keyring file and the next
        restart's bootstrap would resurrect its hash, silently undoing
        the revocation."""
        if not self.is_admin(actor):
            return -1
        with self._lock:
            doomed = [t for t, u in self._tokens.items() if u == user]
            for t in doomed:
                del self._tokens[t]
            rotated = False
            if user == "root":
                self.root_token = secrets.token_urlsafe(24)
                self._tokens[_th(self.root_token)] = "root"
                rotated = True
            elif user == CRANED_IDENTITY:
                self.craned_token = secrets.token_urlsafe(24)
                self._tokens[_th(self.craned_token)] = CRANED_IDENTITY
                rotated = True
            if doomed or rotated:
                self._save()
            if rotated:
                self._save_keyring()
        return len(doomed)
