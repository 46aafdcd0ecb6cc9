"""Runtime compile sanitizer of the PyTorch port.

Counterpart of ``presto_tpu/utils/compilesan.py``, with the same API,
finding kind and dump schema, so ``python -m tools.prestocheck
--compile-diff DUMP presto_tpu_torch`` reads its dumps. The port compiles
no XLA: what it builds once per key is the composed function of a fused
segment, through its one funnel, ``utils/kernel_cache.get_or_build``
(``get_or_install`` goes through it). Under
``PRESTO_TPU_TORCH_COMPILESAN=1`` (or an explicit :func:`install`), every
build there is charged to its call site, with a repo-only stack, and the
distinct keys seen per site are counted.

A site's budget is the number of distinct pow2-bucket shape signatures
it has built (each integer component of a key of 64 or more rounded up to
its power of two). A site with more distinct raw keys than its budget, and
three or more of them under one signature, composes anew for one shape:
a key component follows the data (a dictionary token, a row count), so
every page composes again and churns the 2,048-entry cache. That is a
``compile-storm`` finding, reported when the budget is crossed.

Gauges ``compilesan.sites``, ``compilesan.builds`` and
``compilesan.storm_sites`` and the counter ``compilesan.site_compiles`` go
to :data:`~presto_tpu_torch.utils.metrics.METRICS`. Family totals
(:meth:`CompileSanitizer.family_totals`, by the key's first component)
reconcile with the engine's own counters: ``fused-segment`` builds equal
``QueryResult.stats["segments"]["compiles"]``, and the total equals the
cache's misses. The reference's ``exchange`` family has none here: the
port's exchanges compile nothing.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Dict, List, Optional

from .locksan import _RAW_LOCK, REPO_ROOT
from .metrics import METRICS

_MAX_FINDINGS = 256
_MAX_STACK = 8
_MAX_KEYS_PER_SITE = 4096  # cap the per-site key census, not the counting
# only shape-scale ints are bucketed: capacities / row counts / chunk sizes
# live at >= 64 (the engine's smallest chunk floor), while channel indices,
# worker counts and dictionary tokens are small DISCRETE domains where two
# distinct values are two legitimately distinct kernels
_BUCKET_FLOOR = 64
# a storm needs one canonical signature absorbing this many distinct raw
# keys — two query literals landing in one pow2 bucket is coincidence,
# three+ is a component tracking data
_STORM_MULT = 3
_THIS_FILE = os.path.abspath(__file__)
_FUNNEL_FILE = os.path.join(os.path.dirname(_THIS_FILE), "kernel_cache.py")
ENV = "PRESTO_TPU_TORCH_COMPILESAN"

# key prefix -> reconciliation family; every other prefix is "other"
_FAMILIES = {"fused-segment": "fused-segment"}


def _stack(skip: int = 2, limit: int = _MAX_STACK) -> List[str]:
    """Repo-only attribution stack ['relpath:lineno', ...] starting `skip`
    frames up (innermost first). The sanitizer's and the kernel-cache
    funnel's own frames are elided — the site that gets charged is the
    caller that ASKED for the build, not the cache that ran it."""
    frames: List[str] = []
    i = skip
    while len(frames) < limit and i < skip + 24:
        try:
            f = sys._getframe(i)
        except ValueError:
            break
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(REPO_ROOT + os.sep) \
                and path not in (_THIS_FILE, _FUNNEL_FILE):
            rel = os.path.relpath(path, REPO_ROOT).replace(os.sep, "/")
            frames.append(f"{rel}:{f.f_lineno}")
        i += 1
    return frames


def pow2_bucket(n: int) -> int:
    """Canonical pow2 bucket of a non-negative int (0 -> 0, 1 -> 1,
    3 -> 4, 100 -> 128). The shape-signature canonicalizer."""
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def _canonical(component):
    """Pow2-bucket every shape-scale int component of a key, recursively.
    Two raw keys with the same canonical form describe the same bucketed
    shape — repeated compiles for one form mean a data-dependent component
    leaked in."""
    if isinstance(component, bool):
        return component
    if isinstance(component, int):
        if component >= _BUCKET_FLOOR:
            return pow2_bucket(component)
        if component <= -_BUCKET_FLOOR:
            return -pow2_bucket(-component)
        return component
    if isinstance(component, tuple):
        return tuple(_canonical(c) for c in component)
    try:
        hash(component)
    except TypeError:
        return repr(component)
    return component


class CompileSanitizer:
    """Process-wide per-call-site compile census."""

    def __init__(self):
        self._meta = _RAW_LOCK()
        self._tls = threading.local()
        self._findings: List[dict] = []
        self._reported: set = set()
        # site -> {"keys": set, "buckets": {canonical -> distinct keys},
        #          "builds": int, "prefix": str, "stack": [...],
        #          "budget_extra": int}
        self._sites: Dict[str, dict] = {}
        self._total_builds = 0

    # ------------------------------------------------------------ reentrancy

    def _busy(self) -> bool:
        return getattr(self._tls, "busy", False)

    class _Quiet:
        """Reentrancy guard: a build triggered while a note is already
        recording on this thread (a make() that recursively misses) is
        skipped instead of deadlocking on the non-reentrant meta lock."""

        __slots__ = ("tls",)

        def __init__(self, tls):
            self.tls = tls

        def __enter__(self):
            self.tls.busy = True

        def __exit__(self, *exc):
            self.tls.busy = False
            return False

    # ------------------------------------------------------------- recording

    def note_build(self, key: tuple) -> None:
        """One kernel actually built (a cache miss whose make() ran) for
        `key`, charged to the innermost repo frame outside the funnel."""
        if self._busy():
            return
        with self._Quiet(self._tls):
            st = _stack(3)
            site = st[0] if st else "<unknown>"
            try:
                canon = _canonical(key)
            except Exception:  # unhashable exotic key: census by repr
                key = repr(key)
                canon = key
            prefix = key[0] if isinstance(key, tuple) and key \
                and isinstance(key[0], str) else "?"
            storm = None
            with self._meta:
                e = self._sites.get(site)
                if e is None:
                    e = self._sites[site] = {
                        "keys": set(), "buckets": {}, "builds": 0,
                        "prefix": prefix, "stack": st, "budget_extra": 0}
                e["builds"] += 1
                self._total_builds += 1
                if len(e["keys"]) < _MAX_KEYS_PER_SITE \
                        and key not in e["keys"]:
                    e["keys"].add(key)
                    e["buckets"][canon] = e["buckets"].get(canon, 0) + 1
                storm = self._judge(site, e)
            METRICS.count("compilesan.site_compiles")
            if storm is not None:
                self._storm(*storm)

    @staticmethod
    def _judge(site: str, e: dict):
        """Storm verdict for one site (meta lock held): distinct keys over
        budget AND one canonical signature absorbing >= _STORM_MULT keys."""
        budget = len(e["buckets"]) + e["budget_extra"]
        mult = max(e["buckets"].values(), default=0)
        if len(e["keys"]) > budget and mult >= _STORM_MULT:
            return (site, len(e["keys"]), budget, mult,
                    e["prefix"], list(e["stack"]))
        return None

    def _storm(self, site, nkeys, budget, mult, prefix, stack) -> None:
        self._report(
            "compile-storm", ("storm", site),
            f"call site {site} compiled {nkeys} distinct {prefix!r} "
            f"kernels for only {budget} pow2-bucketed shape signature(s) "
            f"({mult} keys share one signature) — a key component varies "
            "with data (exact row count / float / object identity) and "
            "every page composes anew",
            site=site, stack=stack)

    def set_budget_extra(self, site: str, extra: int) -> None:
        """Raise one site's budget above the shape-bucket default (for
        sites whose key legitimately carries a bounded non-shape domain
        the canonicalizer cannot see). Test/override hook."""
        with self._meta:
            e = self._sites.setdefault(site, {
                "keys": set(), "buckets": {}, "builds": 0,
                "prefix": "?", "stack": [], "budget_extra": 0})
            e["budget_extra"] = int(extra)

    def _report(self, kind: str, key: tuple, message: str, site: str,
                stack: List[str]) -> None:
        t = threading.current_thread()
        with self._meta:
            if (kind, key) in self._reported:
                return
            self._reported.add((kind, key))
            if len(self._findings) >= _MAX_FINDINGS:
                return
            self._findings.append({
                "kind": kind, "message": message, "site": site,
                "stack": list(stack), "thread": t.name,
            })

    # ------------------------------------------------------------- exit gate

    def check_exit(self) -> None:
        """Re-judge every site against its budget (storms are reported the
        moment the budget is crossed; this is the idempotent backstop for
        atexit and explicit end-of-query/test gates)."""
        with self._meta:
            snap = [self._judge(s, e) for s, e in self._sites.items()]
        for storm in snap:
            if storm is not None:
                self._storm(*storm)

    # --------------------------------------------------------------- reading

    def total_builds(self) -> int:
        with self._meta:
            return self._total_builds

    def site_stats(self) -> Dict[str, dict]:
        """site -> {"builds", "distinct_keys", "buckets", "budget",
        "prefix"} — the `compilesan.site_compiles` per-site breakdown."""
        with self._meta:
            return {s: {"builds": e["builds"],
                        "distinct_keys": len(e["keys"]),
                        "buckets": len(e["buckets"]),
                        "budget": len(e["buckets"]) + e["budget_extra"],
                        "prefix": e["prefix"]}
                    for s, e in self._sites.items()}

    def family_totals(self) -> Dict[str, int]:
        """Builds per reconciliation family: 'fused-segment' (the segment
        composer) and 'other' (every other kernel-cache build)."""
        out = {"fused-segment": 0, "other": 0}
        with self._meta:
            for e in self._sites.values():
                fam = _FAMILIES.get(e["prefix"], "other")
                out[fam] += e["builds"]
        return out

    def findings(self) -> List[dict]:
        with self._meta:
            return [dict(f) for f in self._findings]

    def report(self) -> str:
        fs = self.findings()
        stats = self.site_stats()
        if not fs:
            return (f"compilesan: clean ({len(stats)} compile sites, "
                    f"{self.total_builds()} builds, 0 findings)")
        lines = [f"compilesan: {len(fs)} finding(s):"]
        for f in fs:
            lines.append(f"  [{f['kind']}] {f['message']} "
                         f"(thread {f['thread']}, at {f['site']})")
            for frame in f["stack"][1:]:
                lines.append(f"      from {frame}")
        return "\n".join(lines)

    def assert_clean(self) -> None:
        self.check_exit()
        fs = self.findings()
        assert not fs, self.report()

    def dump(self, path: str) -> str:
        """Findings + per-site census JSON — the runtime half a developer
        diffs against the static `retrace-risk` / `cache-key-hygiene`
        findings via ``python -m tools.prestocheck --compile-diff``."""
        with self._meta:
            sites = [{"site": s, "stack": list(e["stack"]),
                      "prefix": e["prefix"], "builds": e["builds"],
                      "distinct_keys": len(e["keys"]),
                      "budget": len(e["buckets"]) + e["budget_extra"]}
                     for s, e in self._sites.items()]
        doc = {"total_builds": self.total_builds(),
               "families": self.family_totals(),
               "sites": sites, "findings": self.findings()}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        return path

    def absorb(self, findings: List[dict]) -> None:
        """Re-inject findings captured before a reset() — the test harness
        isolates deliberate-storm fixtures without losing real engine
        findings a sanitized run accumulated earlier."""
        with self._meta:
            for f in findings:
                if len(self._findings) < _MAX_FINDINGS:
                    self._findings.append(dict(f))

    def reset(self) -> None:
        with self._meta:
            self._findings.clear()
            self._reported.clear()
            self._sites.clear()
            self._total_builds = 0


SANITIZER = CompileSanitizer()


# ---------------------------------------------------------------------------
# install / uninstall
# ---------------------------------------------------------------------------

_installed = False
_PATCHED: List[tuple] = []   # (owner, attr, raw, wrapper) for uninstall


def _patch(owner, attr: str, wrapper) -> None:
    _PATCHED.append((owner, attr, getattr(owner, attr), wrapper))
    setattr(owner, attr, wrapper)


def _atexit_check() -> None:
    if not _installed:
        return
    SANITIZER.check_exit()
    fs = SANITIZER.findings()
    if fs:
        print(SANITIZER.report(), file=sys.stderr)


def install() -> CompileSanitizer:
    """Instrument the composition funnel (idempotent). ``get_or_install``
    resolves ``get_or_build`` through the module global at call time, so
    wrapping the module attribute observes every composition; a cache hit
    is not charged."""
    global _installed
    if _installed:
        return SANITIZER
    from . import kernel_cache as _kc

    raw_get_or_build = _kc.get_or_build

    def get_or_build(key, make):
        fn, built = raw_get_or_build(key, make)
        if built:
            SANITIZER.note_build(key)
        return fn, built

    _patch(_kc, "get_or_build", get_or_build)

    METRICS.set_gauge("compilesan.sites",
                      lambda: len(SANITIZER.site_stats()))
    METRICS.set_gauge("compilesan.builds",
                      lambda: SANITIZER.total_builds())
    METRICS.set_gauge("compilesan.storm_sites",
                      lambda: len(SANITIZER.findings()))

    atexit.register(_atexit_check)
    _installed = True
    return SANITIZER


def uninstall() -> None:
    """Put back the raw funnel. The census survives (tests read findings
    after), but no new builds are recorded."""
    global _installed
    if not _installed:
        return
    while _PATCHED:
        owner, attr, raw, wrapper = _PATCHED.pop()
        if getattr(owner, attr) is wrapper:
            setattr(owner, attr, raw)
    try:
        atexit.unregister(_atexit_check)
    except Exception:
        pass  # best-effort: atexit may already be draining
    _installed = False


def enabled() -> bool:
    return _installed


def install_from_env() -> bool:
    """The PRESTO_TPU_TORCH_COMPILESAN=1 hook of
    ``presto_tpu_torch/__init__``."""
    if os.environ.get(ENV) in ("1", "true", "on"):
        install()
        return True
    return False
