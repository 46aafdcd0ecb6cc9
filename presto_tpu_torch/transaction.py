"""Transaction manager of the PyTorch port: per-query transactions over
connector hooks (counterpart of ``presto_tpu/transaction.py``). Nothing in
the port calls it yet: the statement protocol of the server does, in the
reference.

Analogue of transaction/InMemoryTransactionManager.java (narrowed to this
engine's single-statement auto-commit model, which is also how the vast
majority of reference queries run): every query begins a transaction,
connectors join lazily the first time the query touches them, and the
transaction commits on success / aborts on failure, invoking each joined
connector's hooks. Connectors without transaction support join as no-ops.

Isolation contract matches the reference's read-committed floor for the
memory connector: writes publish atomically at commit (the TableWriter
already buffers until finish), and a failed query's staged files/tables are
rolled back via the connector hook.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Dict, List, Optional


@dataclasses.dataclass
class TransactionInfo:
    transaction_id: str
    query_id: str
    create_time: float
    joined: List[str] = dataclasses.field(default_factory=list)
    state: str = "ACTIVE"      # ACTIVE | COMMITTED | ABORTED


class TransactionManager:
    def __init__(self, catalogs):
        self._catalogs = catalogs
        self._active: Dict[str, TransactionInfo] = {}
        self._lock = threading.Lock()

    def _get_connector(self, catalog: str):
        get = getattr(self._catalogs, "connector", None) or self._catalogs.get
        return get(catalog)

    def catalog_names(self):
        names = getattr(self._catalogs, "names", None)
        return list(names()) if names is not None else []

    def begin(self, query_id: str) -> TransactionInfo:
        tx = TransactionInfo(f"tx_{uuid.uuid4().hex[:12]}", query_id,
                             time.time())
        with self._lock:
            self._active[tx.transaction_id] = tx
        return tx

    def join(self, tx: Optional[TransactionInfo], catalog: str) -> None:
        """Lazily enroll a connector the first time the query touches it
        (InMemoryTransactionManager.checkConnectorWrite analogue)."""
        if tx is None or catalog in tx.joined:
            return
        tx.joined.append(catalog)
        conn = self._get_connector(catalog)
        begin = getattr(conn, "begin_transaction", None)
        if begin is not None:
            begin(tx.transaction_id)

    def _finish(self, tx: TransactionInfo, commit: bool) -> None:
        with self._lock:
            if tx.state != "ACTIVE":
                return
            tx.state = "FINISHING"
        failed: Optional[BaseException] = None
        for i, catalog in enumerate(tx.joined):
            conn = self._get_connector(catalog)
            hook = getattr(conn, "commit_transaction" if commit
                           else "rollback_transaction", None)
            if hook is None:
                continue
            try:
                hook(tx.transaction_id)
            except Exception as e:  # noqa: BLE001
                if not commit:
                    continue  # rollback is best-effort cleanup
                # commit failed mid-way: roll back every remaining connector
                # (the already-committed ones cannot be undone — same partial
                # outcome as the reference's multi-connector commit)
                failed = e
                for rest in tx.joined[i:]:
                    rb = getattr(self._get_connector(rest),
                                 "rollback_transaction", None)
                    if rb is not None:
                        try:
                            rb(tx.transaction_id)
                        except Exception:  # noqa: BLE001
                            pass
                break
        with self._lock:
            tx.state = "ABORTED" if (failed or not commit) else "COMMITTED"
            self._active.pop(tx.transaction_id, None)
        if failed is not None:
            raise failed

    def commit(self, tx: TransactionInfo) -> None:
        self._finish(tx, commit=True)

    def abort(self, tx: TransactionInfo) -> None:
        self._finish(tx, commit=False)

    def active_transactions(self) -> List[TransactionInfo]:
        with self._lock:
            return list(self._active.values())
