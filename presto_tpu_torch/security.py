"""Access control of the PyTorch port: system-level authorization hooks.

Counterpart of ``presto_tpu/security.py``; ``LocalQueryRunner.
execute(sql, user=...)`` checks a statement against the runner's
``access_control`` right after the parse (``runner._check_access``).

Analogue of security/AccessControlManager.java + the file-based system
access control plugin (FileBasedSystemAccessControl): every query checks
can-execute; every table touch checks can-select (or create/insert/drop for
DDL/DML) against an ordered rule list. First matching rule wins; no match =
deny (the reference's file rules behave the same way). Default manager is
allow-all, so embedding the engine stays zero-config.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence


class AccessDeniedException(Exception):
    pass


@dataclasses.dataclass
class AccessRule:
    """One file rule: user/catalog/schema/table regexes -> allowed privileges."""
    user_regex: str = ".*"
    catalog_regex: str = ".*"
    schema_regex: str = ".*"
    table_regex: str = ".*"
    privileges: Sequence[str] = ("select", "insert", "create", "drop",
                                 "execute")

    def matches(self, user: str, catalog: str = "", schema: str = "",
                table: str = "") -> bool:
        return bool(re.fullmatch(self.user_regex, user or "")
                    and re.fullmatch(self.catalog_regex, catalog or "")
                    and re.fullmatch(self.schema_regex, schema or "")
                    and re.fullmatch(self.table_regex, table or ""))


class AccessControl:
    """SPI surface (spi/security/SystemAccessControl.java, narrowed)."""

    def check_can_execute_query(self, user: str) -> None:
        pass

    def check_can_select(self, user: str, catalog: str, schema: str,
                         table: str) -> None:
        pass

    def check_can_write(self, user: str, catalog: str, schema: str,
                        table: str, privilege: str) -> None:
        """privilege in {insert, create, drop}."""


class AllowAllAccessControl(AccessControl):
    pass


class FileBasedAccessControl(AccessControl):
    """Ordered-rule authorization (FileBasedSystemAccessControl analogue)."""

    def __init__(self, rules: Sequence[AccessRule]):
        self.rules = list(rules)

    def _check(self, privilege: str, user: str, catalog: str = "",
               schema: str = "", table: str = "") -> None:
        for rule in self.rules:
            if rule.matches(user, catalog, schema, table):
                if privilege in rule.privileges:
                    return
                break  # first match wins, even when it denies
        target = ".".join(p for p in (catalog, schema, table) if p)
        raise AccessDeniedException(
            f"Access Denied: user {user!r} cannot {privilege}"
            + (f" on {target}" if target else ""))

    def check_can_execute_query(self, user: str) -> None:
        self._check("execute", user)

    def check_can_select(self, user: str, catalog: str, schema: str,
                         table: str) -> None:
        self._check("select", user, catalog, schema, table)

    def check_can_write(self, user: str, catalog: str, schema: str,
                        table: str, privilege: str) -> None:
        self._check(privilege, user, catalog, schema, table)


# ---------------------------------------------------------------------------
# authentication (the reference's server/security/ + password-authenticators
# plugin: presto-password-authenticators/.../file/FileAuthenticator)
# ---------------------------------------------------------------------------

class AuthenticationException(Exception):
    pass


class PasswordAuthenticator:
    """spi/security/PasswordAuthenticator analogue: credentials -> principal.

    Raises AuthenticationException on bad credentials."""

    def authenticate(self, user: str, password: str) -> str:
        raise NotImplementedError


class StaticPasswordAuthenticator(PasswordAuthenticator):
    """In-memory user->password map (testing / embedded use)."""

    def __init__(self, users: dict):
        self._users = dict(users)

    def authenticate(self, user: str, password: str) -> str:
        import hmac

        expect = self._users.get(user)
        if expect is None or not hmac.compare_digest(str(expect), password):
            raise AuthenticationException(f"invalid credentials for {user!r}")
        return user


class FileBasedPasswordAuthenticator(PasswordAuthenticator):
    """Password file: one `user:spec` per line, where spec is either
    `plain:<password>` or `pbkdf2:<iterations>:<salt_hex>:<sha256_hex>`
    (create entries with `hash_password()`). The reference's file
    authenticator reads htpasswd-style BCrypt/PBKDF2 entries the same way.
    """

    def __init__(self, path: str):
        self._users = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                user, _, spec = line.partition(":")
                self._users[user] = spec

    # fixed-cost rejection for unknown users: without this, a real user's
    # wrong password costs ~100k PBKDF2 iterations while an unknown user
    # fails instantly — a username-enumeration timing oracle
    _DUMMY_SPEC = ("pbkdf2:100000:" + "00" * 16 + ":" + "00" * 32)

    def authenticate(self, user: str, password: str) -> str:
        import hashlib
        import hmac

        spec = self._users.get(user)
        if spec is None:
            spec = self._DUMMY_SPEC
            user_known = False
        else:
            user_known = True
        kind, _, rest = spec.partition(":")
        if kind == "plain":
            ok = hmac.compare_digest(rest, password)
        elif kind == "pbkdf2":
            try:
                iters, salt_hex, hash_hex = rest.split(":")
                digest = hashlib.pbkdf2_hmac(
                    "sha256", password.encode(), bytes.fromhex(salt_hex),
                    int(iters))
                ok = hmac.compare_digest(digest.hex(), hash_hex)
            except (ValueError, TypeError):
                raise AuthenticationException(
                    f"malformed password entry for {user!r}")
        else:
            raise AuthenticationException(
                f"unsupported password scheme {kind!r} for {user!r}")
        if not ok or not user_known:
            raise AuthenticationException(f"invalid credentials for {user!r}")
        return user


def hash_password(password: str, iterations: int = 100_000) -> str:
    """-> `pbkdf2:<iters>:<salt>:<hash>` spec for the password file."""
    import hashlib
    import os

    salt = os.urandom(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iterations)
    return f"pbkdf2:{iterations}:{salt.hex()}:{digest.hex()}"
