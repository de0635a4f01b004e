"""Offline campaign/serve spec validation — lint before you burn card time.

Port of `tpu_matmul_bench/analysis/spec_lint.py` (stdlib; copied, since
the port imports nothing of the JAX package). `campaign/spec.py` validates
what it must to build a job plan (top-level keys, programs, duplicate
ids); everything else is deliberately permissive at run time. That
permissiveness is where typos hide: an unknown job-level key (`timout_s`)
is silently ignored, a size that doesn't divide the mesh fails an hour
into the sweep, and two jobs that expand to the same argv silently share
one resume slot. This module checks all of it statically, without
touching a device.

Its vocabulary is the port's: the flags of the port's own parsers
(`serve/cli.py`, `obs/cli.py`), its campaign programs, wire grammar and
comms model. A spec that names the JAX package's `--matmul-impl pallas`
is therefore wrong for the port, which has `cuda` in its place; on a spec
that names no `pallas` impl the findings are JAX's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from tpu_matmul_bench_torch.analysis.findings import Finding

# key vocabulary per spec table, mirroring what campaign/spec.py actually
# reads — anything else is dead weight the executor will never see
_CAMPAIGN_KEYS = {"name"}
_DEFAULTS_KEYS = {"flags", "timeout_s", "retries", "backoff_s",
                  "heartbeat_s"}
_JOB_KEYS = {"id", "program", "flags", "timeout_s", "retries", "backoff_s",
             "heartbeat_s"}
_SWEEP_KEYS = {"id_prefix", "program", "flags", "timeout_s", "retries",
               "backoff_s", "heartbeat_s", "sizes", "modes", "dtypes",
               "num_devices"}

# modes whose program shards the [size, size] problem over the device
# axis and therefore needs size % num_devices == 0
_DIVISIBILITY_MODES = {"matrix_parallel", "model_parallel"}

# serve-CLI subcommands a campaign may schedule (the semantic subset:
# explain/trace/pod are interactive or CI-only) and flag SEMANTICS that
# argparse cannot express (positivity, scheduler vocabulary). The flag
# VOCABULARY itself is derived from the real parsers below, so it cannot
# drift from the CLI (a hand-kept list once missed --obs-exemplars, and
# every spec using it was a false SPEC-002).
_SERVE_SUBCOMMANDS = ("bench", "ab", "selftest")
# flags whose value must be a strictly positive number
_SERVE_POSITIVE_FLAGS = {"--qps", "--duration", "--concurrency",
                         "--window-ms", "--starvation-ms", "--max-depth",
                         "--max-batch", "--cache-capacity"}
_SERVE_SCHEDULERS = ("fixed", "continuous")

#: derived-parser vocabulary cache; built once per process on first use
_VOCAB_CACHE: dict[str, Any] = {}


def _subparsers_of(parser: Any) -> dict[str, Any]:
    """name -> subparser from an argparse parser's _SubParsersAction."""
    import argparse

    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return dict(action.choices)
    return {}


def _flags_of(parser: Any) -> set[str]:
    """The --long option strings a subparser accepts, minus --help."""
    return {opt for action in parser._actions
            for opt in action.option_strings
            if opt.startswith("--")} - {"--help"}


def _bool_flags_of(parser: Any) -> set[str]:
    """The zero-argument (store_true/store_const) --long options."""
    return {opt for action in parser._actions if action.nargs == 0
            for opt in action.option_strings
            if opt.startswith("--")} - {"--help"}


def _serve_vocab() -> tuple[set[str], set[str], set[str]]:
    """(common, bench/ab-only, zero-arg) serve flags, introspected from
    serve/cli.py's real parser — the vocabulary can no longer drift
    from the CLI because it IS the CLI."""
    if "serve" not in _VOCAB_CACHE:
        from tpu_matmul_bench_torch.serve.cli import build_parser

        subs = _subparsers_of(build_parser())
        per = {name: _flags_of(subs[name]) for name in _SERVE_SUBCOMMANDS}
        common = set.intersection(*per.values())
        bench_only = (per["bench"] | per["ab"]) - common
        bools = set().union(*(_bool_flags_of(subs[name])
                              for name in _SERVE_SUBCOMMANDS))
        _VOCAB_CACHE["serve"] = (common, bench_only, bools)
    return _VOCAB_CACHE["serve"]


def _raw_flag_values(argv: list[str], flag: str) -> list[str]:
    """Raw tokens following `flag` up to the next option, NO comma split —
    for values whose grammar owns its commas (per-link --comm-quant,
    --mesh factorizations)."""
    out: list[str] = []
    try:
        i = argv.index(flag)
    except ValueError:
        return out
    for tok in argv[i + 1:]:
        if tok.startswith("--"):
            break
        out.append(tok)
    return out


def _flag_values(argv: list[str], flag: str) -> list[str]:
    """Values following `flag` up to the next option, commas split."""
    return [t for tok in _raw_flag_values(argv, flag)
            for t in tok.split(",") if t]


def _comm_quant_values(argv: list[str]) -> list[str]:
    """--comm-quant values with the per-link grammar respected: a token
    containing '=' is one per-link spec (its commas separate link
    classes, not sweep points); plain tokens keep the sweep-list comma
    split."""
    out: list[str] = []
    for tok in _raw_flag_values(argv, "--comm-quant"):
        if "=" in tok:
            out.append(tok)
        else:
            out.extend(t for t in tok.split(",") if t)
    return out


def _serve_flag_items(argv: list[str], bool_flags: set[str],
                      ) -> tuple[list[tuple[str, str | None]],
                                 list[str]]:
    """(flag, value) pairs + stray positional tokens from a CLI job's
    argv tail (after the subcommand). Handles --flag=value and the
    caller's zero-argument flags; an unknown flag is assumed to take a
    value."""
    items: list[tuple[str, str | None]] = []
    strays: list[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            strays.append(tok)
            i += 1
            continue
        flag, eq, inline = tok.partition("=")
        if eq:
            items.append((flag, inline))
            i += 1
        elif flag in bool_flags:
            items.append((flag, None))
            i += 1
        else:
            val = argv[i + 1] if i + 1 < len(argv) \
                and not argv[i + 1].startswith("--") else None
            items.append((flag, val))
            i += 2 if val is not None else 1
    return items, strays


def _lint_serve_job(job: Any, where: str,
                    spec_dir: Path | None = None) -> list[Finding]:
    """The serve analog of the round.toml job checks: subcommand + flag
    vocabulary (SPEC-002), mix/grid/load/scheduler validity (SPEC-001),
    tenant definitions (SPEC-005/SPEC-006), and a padding-grid coverage
    warning (SPEC-003)."""
    from tpu_matmul_bench_torch.serve.loadgen import parse_mix
    from tpu_matmul_bench_torch.serve.queue import DEFAULT_GRID

    argv = list(job.argv)
    if not argv or argv[0] not in _SERVE_SUBCOMMANDS:
        return [Finding(
            "SPEC-001", where,
            f"serve job must start with a subcommand "
            f"{_SERVE_SUBCOMMANDS}, got {argv[:1] or '[]'}",
            details={"argv": argv})]
    sub = argv[0]
    common, bench_only, bool_flags = _serve_vocab()
    known = common | (bench_only if sub in ("bench", "ab") else set())
    findings: list[Finding] = []
    items, strays = _serve_flag_items(argv[1:], bool_flags)
    for tok in strays:
        findings.append(Finding(
            "SPEC-001", where,
            f"stray positional token {tok!r} in serve {sub} flags",
            details={"token": tok}))
    values: dict[str, str | None] = {}
    for flag, val in items:
        if flag not in known:
            findings.append(Finding(
                "SPEC-002", where,
                f"unknown serve {sub} flag {flag!r} (the job would crash "
                "at spawn time)",
                details={"flag": flag, "known": sorted(known)}))
            continue
        values[flag] = val

    mix = values.get("--mix")
    mix_entries = ()
    if mix is not None:
        try:
            mix_entries = parse_mix(mix)
        except ValueError as e:
            findings.append(Finding(
                "SPEC-001", where, f"bad --mix: {e}",
                details={"mix": mix}))
    grid = tuple(DEFAULT_GRID)
    if values.get("--grid") is not None:
        try:
            grid = tuple(int(g) for g in values["--grid"].split(",") if g)
            if not grid or any(g < 1 for g in grid):
                raise ValueError(f"grid needs positive points, got {grid!r}")
        except ValueError as e:
            findings.append(Finding(
                "SPEC-001", where, f"bad --grid: {e}",
                details={"grid": values["--grid"]}))
            grid = tuple(DEFAULT_GRID)
    for flag in sorted(_SERVE_POSITIVE_FLAGS & set(values)):
        try:
            num = float(values[flag])
        except (TypeError, ValueError):
            num = -1.0
        if num <= 0:
            findings.append(Finding(
                "SPEC-001", where,
                f"{flag} must be a positive number, got {values[flag]!r}",
                details={"flag": flag, "value": values[flag]}))
    eps = values.get("--explore")
    if "--explore" in values:
        try:
            eps_num = float(eps) if eps is not None else -1.0
        except ValueError:
            eps_num = -1.0
        if not 0.0 < eps_num <= 1.0:
            findings.append(Finding(
                "SPEC-001", where,
                f"--explore must be a shadow-traffic fraction in (0, 1], "
                f"got {eps!r}",
                details={"explore": eps}))
    sched = values.get("--scheduler")
    if sched is not None and sched not in _SERVE_SCHEDULERS:
        findings.append(Finding(
            "SPEC-001", where,
            f"--scheduler must be one of {_SERVE_SCHEDULERS}, "
            f"got {sched!r}",
            details={"scheduler": sched}))
    if "--tenants" in values:
        findings.extend(
            _lint_tenants_value(values["--tenants"], where, spec_dir))
    # coverage analog of the mesh-divisibility warn: a mix dim above the
    # grid top compiles an off-grid executable per shape (cache churn and
    # padding waste the grid was supposed to bound)
    top = max(grid)
    for entry in mix_entries:
        dims = (entry.m, entry.k, entry.n)
        over = [d for d in dims if d > top]
        if over:
            findings.append(Finding(
                "SPEC-003", where,
                f"mix shape {'x'.join(str(d) for d in dims)} exceeds the "
                f"padding-grid top {top} — each such shape compiles its "
                "own off-grid executable",
                details={"dims": list(dims), "grid_top": top}))
    return findings


# obs-CLI subcommands a campaign may schedule (ingest after a sweep,
# detect as a gate) plus the value semantics argparse cannot express;
# the per-subcommand flag vocabulary is introspected from obs/cli.py's
# real parser, same contract as _serve_vocab
_OBS_SUBCOMMANDS = ("status", "selftest", "ingest", "history", "detect",
                    "report")


def _obs_vocab() -> tuple[dict[str, set[str]], set[str]]:
    """(subcommand -> flags, zero-arg flags) for the observatory CLI,
    introspected from obs/cli.py's real parser."""
    if "obs" not in _VOCAB_CACHE:
        from tpu_matmul_bench_torch.obs.cli import build_parser

        subs = _subparsers_of(build_parser())
        by_sub = {name: _flags_of(subs[name])
                  for name in _OBS_SUBCOMMANDS}
        bools = set().union(*(_bool_flags_of(subs[name])
                              for name in _OBS_SUBCOMMANDS))
        _VOCAB_CACHE["obs"] = (by_sub, bools)
    return _VOCAB_CACHE["obs"]
#: flags that must parse as a strictly positive integer
_OBS_POSITIVE_INT_FLAGS = {"--detect-window", "--stale-rounds", "--seq"}
#: flags that must parse as a strictly positive number
_OBS_POSITIVE_FLAGS = {"--threshold-pct", "--interval", "--timeout"}
#: subcommands whose positional operands are legitimate
_OBS_POSITIONAL_OK = {"status", "ingest"}
_OBS_HISTORY_ACTIONS = ("show", "selftest")


def _lint_obs_job(job: Any, where: str) -> list[Finding]:
    """The observatory analog of `_lint_serve_job`: subcommand check
    (SPEC-001), per-subcommand flag vocabulary (SPEC-002), and value
    validity for the detection windows (SPEC-001) — so a campaign that
    schedules `obs detect --detect-window 0` dies at lint, not an hour
    into the sweep."""
    from tpu_matmul_bench_torch.analysis.findings import SEVERITIES

    argv = list(job.argv)
    if not argv or argv[0] not in _OBS_SUBCOMMANDS:
        return [Finding(
            "SPEC-001", where,
            f"obs job must start with a subcommand {_OBS_SUBCOMMANDS}, "
            f"got {argv[:1] or '[]'}",
            details={"argv": argv})]
    sub = argv[0]
    by_sub, bool_flags = _obs_vocab()
    known = by_sub[sub]
    findings: list[Finding] = []
    # the shared tokenizer, parameterized with obs's own zero-argument
    # flags so `--json`-style options never capture the next token
    fixed_items, strays = _serve_flag_items(argv[1:], bool_flags)
    if sub == "history":
        # optional positional action
        actions = [s for s in strays]
        strays = []
        for act in actions:
            if act not in _OBS_HISTORY_ACTIONS:
                findings.append(Finding(
                    "SPEC-001", where,
                    f"obs history action must be one of "
                    f"{_OBS_HISTORY_ACTIONS}, got {act!r}",
                    details={"action": act}))
    elif sub not in _OBS_POSITIONAL_OK:
        for tok in strays:
            findings.append(Finding(
                "SPEC-001", where,
                f"stray positional token {tok!r} in obs {sub} flags",
                details={"token": tok}))
        strays = []
    values: dict[str, str | None] = {}
    for flag, val in fixed_items:
        if flag not in known:
            findings.append(Finding(
                "SPEC-002", where,
                f"unknown obs {sub} flag {flag!r} (the job would crash "
                "at spawn time)",
                details={"flag": flag, "known": sorted(known)}))
            continue
        values[flag] = val
    for flag in sorted(_OBS_POSITIVE_INT_FLAGS & set(values)):
        val = values[flag]
        try:
            ok = val is not None and int(val) > 0
        except ValueError:
            ok = False
        if not ok:
            findings.append(Finding(
                "SPEC-001", where,
                f"{flag} must be a positive integer, got {val!r}",
                details={"flag": flag, "value": val}))
    for flag in sorted(_OBS_POSITIVE_FLAGS & set(values)):
        val = values[flag]
        try:
            ok = val is not None and float(val) > 0
        except ValueError:
            ok = False
        if not ok:
            findings.append(Finding(
                "SPEC-001", where,
                f"{flag} must be a positive number, got {val!r}",
                details={"flag": flag, "value": val}))
    if "--fail-on" in values and values["--fail-on"] not in SEVERITIES:
        findings.append(Finding(
            "SPEC-001", where,
            f"--fail-on must be one of {SEVERITIES}, "
            f"got {values['--fail-on']!r}",
            details={"fail_on": values["--fail-on"]}))
    return findings


def _lint_tenants_data(data: Any, where: str) -> list[Finding]:
    """All findings for a parsed ``{"tenants": {...}}`` root: unknown
    keys per block (SPEC-002), bounds/profile validity (SPEC-005),
    normalized-id duplicates (SPEC-006). Reports every violation, unlike
    the runtime loader which raises on the first."""
    from tpu_matmul_bench_torch.serve.tenants import (
        TENANT_KEYS,
        TenantSpecError,
        _norm_id,
        tenant_from_dict,
    )

    table = data.get("tenants") if isinstance(data, dict) else None
    if not isinstance(table, dict) or not table:
        return [Finding(
            "SPEC-001", where,
            "tenant file needs a non-empty [tenants.<id>] table")]
    findings: list[Finding] = []
    seen: dict[str, str] = {}
    for tid, entry in table.items():
        label = f"{where}:tenants.{tid}"
        if isinstance(entry, dict):
            for key in sorted(set(entry) - TENANT_KEYS):
                findings.append(Finding(
                    "SPEC-002", label,
                    f"unknown tenant key {key!r} (silently ignored at "
                    "run time)",
                    details={"key": key, "known": sorted(TENANT_KEYS)}))
        try:
            spec = tenant_from_dict(str(tid), entry)
        except TenantSpecError as e:
            findings.append(Finding("SPEC-005", label, str(e),
                                    details={"tenant": str(tid)}))
            continue
        norm = _norm_id(spec.tenant_id)
        if norm in seen:
            findings.append(Finding(
                "SPEC-006", label,
                f"duplicate tenant id {spec.tenant_id!r} (collides with "
                f"{seen[norm]!r} after case/whitespace normalization)",
                details={"tenant": spec.tenant_id,
                         "collides_with": seen[norm]}))
        else:
            seen[norm] = spec.tenant_id
    return findings


def _lint_tenants_value(value: str | None, where: str,
                        spec_dir: Path | None) -> list[Finding]:
    """A serve job's ``--tenants`` value: a TOML path (resolved against
    the cwd like the executor will, then against the spec's directory)
    linted in place, or the inline form parsed the way the CLI would."""
    from tpu_matmul_bench_torch.campaign.spec import CampaignSpecError, _parse_toml
    from tpu_matmul_bench_torch.serve.tenants import (
        TenantSpecError,
        parse_tenants_arg,
    )

    if value is None:
        return [Finding("SPEC-001", where, "--tenants needs a value")]
    if value.endswith(".toml"):
        p = Path(value)
        if not p.exists() and spec_dir is not None:
            p = spec_dir / value
        if not p.exists():
            return [Finding(
                "SPEC-001", where,
                f"--tenants file {value!r} not found (looked in the cwd "
                + (f"and {spec_dir}" if spec_dir else "only") + ")",
                details={"tenants": value})]
        try:
            data = _parse_toml(p.read_text())
        except (OSError, CampaignSpecError) as e:
            return [Finding("SPEC-001", where,
                            f"unreadable --tenants file {p}: {e}",
                            details={"tenants": str(p)})]
        return _lint_tenants_data(data, f"{where}:{value}")
    try:
        parse_tenants_arg(value)
    except TenantSpecError as e:
        rule = "SPEC-006" if "duplicate tenant id" in str(e) else "SPEC-005"
        return [Finding(rule, where, f"bad inline --tenants: {e}",
                        details={"tenants": value})]
    return []


# modes whose collectives --comm-quant rewrites; other modes (independent,
# the overlap family) carry no quantizable float collective, so a block
# size cannot be statically wrong there
_QUANTIZABLE_MODES = {"batch_parallel", "data_parallel", "matrix_parallel",
                      "model_parallel", "hybrid", "summa"}


def _comm_quant_findings(job: Any, label: str) -> list[Finding]:
    """SPEC-007 for one job: parse every --comm-quant value against the
    wire-format grammar, then dry-run the wire model over the job's
    (mode, size, num_devices) grid so block/ring divisibility errors
    surface at lint time instead of mid-campaign."""
    import numpy as np

    from tpu_matmul_bench_torch.analysis.comms_model import wire_collectives
    from tpu_matmul_bench_torch.parallel.collectives import parse_wire_format

    argv = list(job.argv)
    # per-link specs ('=' in the value) are SPEC-008's to validate — the
    # uniform wire grammar below would false-positive on their commas
    quants = [q for q in _comm_quant_values(argv) if "=" not in q]
    if not quants:
        return []
    findings: list[Finding] = []
    dtypes = _flag_values(argv, "--dtype") or ["bfloat16"]
    modes = _QUANTIZABLE_MODES & set(_flag_values(argv, "--mode"))
    devs = [int(x) for x in _flag_values(argv, "--num-devices")
            if x.isdigit()]
    sizes = [int(x) for x in _flag_values(argv, "--sizes") if x.isdigit()]
    dps = [int(x) for x in _flag_values(argv, "--dp") if x.isdigit()]
    for q in quants:
        try:
            fmt = parse_wire_format(q)
        except ValueError as e:
            findings.append(Finding(
                "SPEC-007", label, f"bad --comm-quant value: {e}",
                details={"comm_quant": q}))
            continue
        if fmt is None:
            continue
        if all(dt.startswith(("int", "uint")) for dt in dtypes):
            continue  # integer operands keep the exact collective
        for mode in sorted(modes):
            for d in devs or [1]:
                if d <= 1:
                    continue  # the d==1 short-circuit is always valid
                kw = {"dp": dps[0]} if mode == "hybrid" and dps else (
                    {"dp": 2 if d % 2 == 0 else 1} if mode == "hybrid"
                    else {})
                for s in sizes:
                    try:
                        wire_collectives(mode, d, s, np.float32, q, **kw)
                    except ValueError as e:
                        findings.append(Finding(
                            "SPEC-007", label,
                            f"--comm-quant {q} cannot run "
                            f"--mode {mode} --sizes {s} "
                            f"--num-devices {d}: {e}",
                            details={"comm_quant": q, "mode": mode,
                                     "size": s, "num_devices": d}))
    return findings


#: modes that accept a two-axis --mesh factorization
_HIER_MODES = {"hybrid", "summa"}


def _hier_findings(job: Any, label: str) -> list[Finding]:
    """SPEC-008 for one job: the hierarchical-mesh flag family. --mesh
    values must parse the dcn:R,ici:C grammar and factorize the job's
    --num-devices; per-link --comm-quant values must parse the link
    grammar and dry-run the two-level wire model over the job's
    (program, size) grid; --stream-k must be a positive panel count that
    divides every size; --mem-budget-gib must be a positive number."""
    import math

    import numpy as np

    from tpu_matmul_bench_torch.analysis.comms_model import (
        hier_expected_collectives,
    )
    from tpu_matmul_bench_torch.parallel.collectives import parse_link_formats
    from tpu_matmul_bench_torch.parallel.mesh import parse_mesh_spec

    argv = list(job.argv)
    findings: list[Finding] = []
    devs = [int(x) for x in _flag_values(argv, "--num-devices")
            if x.isdigit()]
    sizes = [int(x) for x in _flag_values(argv, "--sizes") if x.isdigit()]
    hier_progs = _HIER_MODES & (
        {job.program} | set(_flag_values(argv, "--mode")))

    meshes = []
    for m in _raw_flag_values(argv, "--mesh"):
        try:
            axes = parse_mesh_spec(m)
        except ValueError as e:
            findings.append(Finding(
                "SPEC-008", label, f"bad --mesh value: {e}",
                details={"mesh": m}))
            continue
        meshes.append(m)
        total = math.prod(d for _, d in axes)
        for d in devs:
            if d != total:
                findings.append(Finding(
                    "SPEC-008", label,
                    f"--mesh {m} factorizes {total} devices but the job "
                    f"runs --num-devices {d}",
                    details={"mesh": m, "num_devices": d}))

    per_link = [q for q in _comm_quant_values(argv) if "=" in q]
    for q in per_link:
        try:
            parse_link_formats(q)
        except ValueError as e:
            findings.append(Finding(
                "SPEC-008", label, f"bad per-link --comm-quant value: {e}",
                details={"comm_quant": q}))
            continue
        if not meshes:
            findings.append(Finding(
                "SPEC-008", label,
                f"per-link --comm-quant {q} without a --mesh "
                "factorization — there is only one (flat) link class to "
                "route over",
                details={"comm_quant": q}))
        # dry-run the two-level wire model: block/ring divisibility
        # errors surface here instead of mid-campaign
        for m in meshes:
            for prog in sorted(hier_progs):
                for s in sizes:
                    try:
                        hier_expected_collectives(prog, m, s, np.float32, q)
                    except ValueError as e:
                        findings.append(Finding(
                            "SPEC-008", label,
                            f"--comm-quant {q} cannot run {prog} "
                            f"--mesh {m} --sizes {s}: {e}",
                            details={"comm_quant": q, "mesh": m,
                                     "program": prog, "size": s}))

    for tok in _flag_values(argv, "--stream-k"):
        try:
            panels = int(tok)
        except ValueError:
            panels = 0
        if panels <= 0:
            findings.append(Finding(
                "SPEC-008", label,
                f"--stream-k must be a positive panel count, got {tok!r}",
                details={"stream_k": tok}))
            continue
        for s in sizes:
            if s % panels:
                findings.append(Finding(
                    "SPEC-008", label,
                    f"--stream-k {panels} panels do not divide size {s}",
                    details={"stream_k": panels, "size": s}))

    for tok in _flag_values(argv, "--mem-budget-gib"):
        try:
            ok = float(tok) > 0
        except ValueError:
            ok = False
        if not ok:
            findings.append(Finding(
                "SPEC-008", label,
                f"--mem-budget-gib must be a positive number, got {tok!r}",
                details={"mem_budget_gib": tok}))
    return findings


def _pod_findings(job: Any, label: str) -> list[Finding]:
    """SPEC-010 for one serve job: the pod serving flag family.

    --replica-groups must be a positive count that divides the outer
    axis of every --mesh factorization (serve/placement.py's partition
    rule — a group spanning a fractional DCN row is cross-group traffic
    by construction); pod flags without --mesh have no pod to shape;
    --num-devices must cover the mesh world; --scheduler fixed cannot
    place (the pod arm requires the continuous scheduler); and every
    per-link --comm-quant must dry-run the pod collective model over
    the job's mix buckets so wire-format divisibility errors surface at
    lint time, not mid-campaign."""
    import numpy as np

    from tpu_matmul_bench_torch.serve.placement import mesh_world, partition_spec

    argv = list(job.argv)
    findings: list[Finding] = []
    group_toks = _flag_values(argv, "--replica-groups")
    meshes = _raw_flag_values(argv, "--mesh")
    if not meshes:
        if group_toks:
            findings.append(Finding(
                "SPEC-010", label,
                "--replica-groups without --mesh — there is no pod "
                "to partition",
                details={"replica_groups": group_toks}))
        return findings

    if "fixed" in _flag_values(argv, "--scheduler"):
        findings.append(Finding(
            "SPEC-010", label,
            "--mesh with --scheduler fixed: pod placement requires the "
            "continuous scheduler (per-group breakers and SLO state)",
            details={}))

    group_counts: list[int] = []
    for tok in group_toks:
        if not tok.isdigit() or int(tok) < 1:
            findings.append(Finding(
                "SPEC-010", label,
                f"--replica-groups must be a positive count, got {tok!r}",
                details={"replica_groups": tok}))
        else:
            group_counts.append(int(tok))

    devs = [int(x) for x in _flag_values(argv, "--num-devices")
            if x.isdigit()]
    per_link = [q for q in _comm_quant_values(argv) if "=" in q]
    dtypes = _flag_values(argv, "--dtype") or ["float32"]
    buckets = _serve_mix_buckets(argv)
    for m in meshes:
        try:
            world = mesh_world(m)
        except ValueError:
            continue  # grammar errors are SPEC-008's to report
        for d in devs:
            if d < world:
                findings.append(Finding(
                    "SPEC-010", label,
                    f"--mesh {m} spans {world} devices but the job caps "
                    f"--num-devices {d}",
                    details={"mesh": m, "num_devices": d}))
        for g in group_counts or [1]:
            try:
                parts = partition_spec(m, g)
            except ValueError as e:
                findings.append(Finding(
                    "SPEC-010", label, str(e),
                    details={"mesh": m, "replica_groups": g}))
                continue
            if all(dt.startswith(("int", "uint")) for dt in dtypes):
                continue  # integer requests keep the exact collective
            # dry-run the pod collective model per group shape: a block
            # format that cannot tile a bucket's gather payload dies
            # here, not an hour into the campaign
            for q in per_link:
                for bm, bk, bn in buckets:
                    try:
                        from tpu_matmul_bench_torch.analysis.comms_model import (
                            pod_expected_collectives,
                        )

                        pod_expected_collectives(
                            parts[0].mesh_spec, bm, bk, bn,
                            np.float32, q)
                    except ValueError as e:
                        findings.append(Finding(
                            "SPEC-010", label,
                            f"--comm-quant {q} cannot serve bucket "
                            f"{bm}x{bk}x{bn} on a {parts[0].mesh_spec} "
                            f"group of --mesh {m}: {e}",
                            details={"comm_quant": q, "mesh": m,
                                     "replica_groups": g,
                                     "bucket": [bm, bk, bn]}))
    return findings


def _serve_mix_buckets(argv: list[str]) -> list[tuple[int, int, int]]:
    """The padded buckets a serve job's --mix lands on (its --grid or
    the default), deduplicated — what the pod wire model must price."""
    from tpu_matmul_bench_torch.serve.loadgen import DEFAULT_MIX, parse_mix
    from tpu_matmul_bench_torch.serve.queue import ShapeGrid

    mixes = _raw_flag_values(argv, "--mix") or [DEFAULT_MIX]
    grid_toks = [int(t) for t in _flag_values(argv, "--grid")
                 if t.isdigit()]
    try:
        grid = ShapeGrid(grid_toks) if grid_toks else ShapeGrid()
        entries = [e for mx in mixes for e in parse_mix(mx)]
    except ValueError:
        return []  # the mix/grid error is SPEC-001's to report
    return sorted({grid.bucket(e.m, e.k, e.n) for e in entries})


def _lint_train_job(job: Any, label: str) -> list[Finding]:
    """SPEC-009 for one train job: subcommand, the --grad-quant grammar
    (minus the legacy control tier, which has no reduce_scatter half),
    per-link values only with a factorized --mesh, --zero ∈ {0, 1},
    --steps ≥ 2 whenever a quantized wire makes the drift series
    measurable, and a dry run of the gradient-collective model over the
    job's (mode, mesh, size, zero) grid — shape/divisibility rejections
    surface at lint time, not mid-campaign."""
    import numpy as np

    from tpu_matmul_bench_torch.analysis.comms_model import (
        train_expected_collectives,
    )
    from tpu_matmul_bench_torch.parallel.collectives import (
        is_per_link_spec,
        parse_wire_format,
        validate_comm_quant,
    )

    argv = list(job.argv)
    findings: list[Finding] = []
    if not ({"bench", "selftest"} & set(argv)):
        findings.append(Finding(
            "SPEC-009", label,
            "train job names no subcommand: expected 'bench' or "
            "'selftest' in the flags",
            details={"argv": argv}))
        return findings
    if "selftest" in argv:
        return findings  # selftest takes only --quiet; nothing to grid

    if _flag_values(argv, "--comm-quant") or "--comm-quant" in argv:
        findings.append(Finding(
            "SPEC-009", label,
            "train takes --grad-quant (gradient collectives), not "
            "--comm-quant", details={}))

    meshes = _raw_flag_values(argv, "--mesh")
    quants = _raw_flag_values(argv, "--grad-quant")
    for q in quants:
        try:
            validate_comm_quant(q)
            if not is_per_link_spec(q):
                fmt = parse_wire_format(q)
                if fmt is not None and fmt.legacy:
                    raise ValueError(
                        f"{q!r} is the legacy control tier, which has no "
                        "reduce_scatter half")
        except ValueError as e:
            findings.append(Finding(
                "SPEC-009", label, f"bad --grad-quant value: {e}",
                details={"grad_quant": q}))
            continue
        if is_per_link_spec(q) and not meshes:
            findings.append(Finding(
                "SPEC-009", label,
                f"per-link --grad-quant {q} without a --mesh "
                "factorization — there is only one (flat) link class to "
                "route over",
                details={"grad_quant": q}))

    zeros: list[int] = []
    for tok in _flag_values(argv, "--zero"):
        if tok not in ("0", "1"):
            findings.append(Finding(
                "SPEC-009", label,
                f"--zero must be 0 or 1, got {tok!r}",
                details={"zero": tok}))
        else:
            zeros.append(int(tok))

    # a quantized gradient wire makes the drift series measurable; a
    # one-step series is a point, not a drift
    wired = [q for q in quants if q != "none"]
    for tok in _flag_values(argv, "--steps"):
        try:
            steps = int(tok)
        except ValueError:
            steps = 0
        if steps < 1:
            findings.append(Finding(
                "SPEC-009", label,
                f"--steps must be a positive count, got {tok!r}",
                details={"steps": tok}))
        elif steps < 2 and wired:
            findings.append(Finding(
                "SPEC-009", label,
                f"--steps {steps} with a quantized --grad-quant: the "
                "update-error drift series needs at least 2 steps to "
                "show drift",
                details={"steps": steps, "grad_quant": wired}))

    # dry-run the gradient-collective model over the job's grid
    devs = [int(x) for x in _flag_values(argv, "--num-devices")
            if x.isdigit()]
    sizes = [int(x) for x in _flag_values(argv, "--sizes") if x.isdigit()]
    modes = _flag_values(argv, "--mode") or ["dp"]
    for mode in modes:
        for mesh in (meshes or [None]):
            for world in (devs or [1]):
                for s in sizes:
                    for q in (quants or [None]):
                        for z in (zeros or [0]):
                            try:
                                train_expected_collectives(
                                    mode, mesh, world, s, np.float32,
                                    None if q == "none" else q,
                                    zero=bool(z))
                            except ValueError as e:
                                findings.append(Finding(
                                    "SPEC-009", label,
                                    f"train --mode {mode} "
                                    f"--mesh {mesh or '(flat)'} --sizes "
                                    f"{s} --zero {z} cannot run: {e}",
                                    details={"mode": mode, "mesh": mesh,
                                             "size": s, "zero": z,
                                             "grad_quant": q}))
    return findings


def _unknown_key_findings(data: dict[str, Any], where: str) -> list[Finding]:
    findings = []

    def check(table: Any, known: set, label: str) -> None:
        if not isinstance(table, dict):
            return
        for key in sorted(set(table) - known):
            findings.append(Finding(
                "SPEC-002", f"{where}:{label}",
                f"unknown key {key!r} (silently ignored at run time)",
                details={"key": key, "known": sorted(known)}))

    check(data.get("campaign", {}), _CAMPAIGN_KEYS, "campaign")
    check(data.get("defaults", {}), _DEFAULTS_KEYS, "defaults")
    for i, entry in enumerate(data.get("job", []) or []):
        check(entry, _JOB_KEYS, f"job[{i}]")
    for i, entry in enumerate(data.get("sweep", []) or []):
        check(entry, _SWEEP_KEYS, f"sweep[{i}]")
    return findings


def lint_spec_file(path: str | Path) -> list[Finding]:
    """All spec findings for one file: parse, vocabulary, divisibility,
    fingerprint identity."""
    from tpu_matmul_bench_torch.campaign.spec import (
        CampaignSpecError,
        _parse_toml,
        spec_from_dict,
    )

    p = Path(path)
    where = str(p)
    try:
        text = p.read_text()
    except OSError as e:
        return [Finding("SPEC-001", where, f"cannot read spec: {e}")]

    try:
        if p.suffix == ".toml":
            data = _parse_toml(text)
        else:
            data = json.loads(text)
    except (CampaignSpecError, ValueError) as e:
        return [Finding("SPEC-001", where, f"spec does not parse: {e}")]
    if not isinstance(data, dict):
        return [Finding("SPEC-001", where,
                        f"spec root must be a table, got {type(data).__name__}")]

    # a standalone tenant-definition file (root is exactly [tenants.*]):
    # not a campaign spec at all — lint the tenant blocks and stop
    if set(data) == {"tenants"}:
        return _lint_tenants_data(data, where)

    # a chaos matrix (root is exactly [chaos]): the fault-injection
    # audit's spec, not a campaign — validate its cells and stop before
    # SPEC-001/002 fire on a vocabulary it never claimed to speak
    if set(data) == {"chaos"}:
        from tpu_matmul_bench_torch.faults.audit import lint_chaos_data

        return lint_chaos_data(data, where)

    # a perf-observatory detection-window spec (root is exactly
    # [history], e.g. specs/history.toml): vocabulary + value ranges for
    # `obs detect`, not a campaign
    if set(data) == {"history"}:
        from tpu_matmul_bench_torch.obs.detect import lint_history_data

        return lint_history_data(data, where)

    findings = _unknown_key_findings(data, where)

    try:
        spec = spec_from_dict(data)
    except CampaignSpecError as e:
        findings.append(Finding("SPEC-001", where, str(e)))
        return findings

    # fingerprint identity: the resume journal keys on fingerprints, so two
    # jobs sharing one means the second silently reuses the first's result
    by_fp: dict[str, str] = {}
    for job in spec.jobs:
        prior = by_fp.setdefault(job.fingerprint, job.job_id)
        if prior != job.job_id:
            findings.append(Finding(
                "SPEC-004", f"{where}:{job.job_id}",
                f"fingerprint {job.fingerprint} collides with job "
                f"{prior!r} — identical program+argv, one resume slot",
                details={"fingerprint": job.fingerprint,
                         "jobs": [prior, job.job_id]}))

    # serve jobs: subcommand + flag vocabulary + mix/grid/load/tenant
    # validation
    for job in spec.jobs:
        if job.program == "serve":
            findings.extend(_lint_serve_job(job, f"{where}:{job.job_id}",
                                            spec_dir=p.parent))
        elif job.program == "obs":
            findings.extend(_lint_obs_job(job, f"{where}:{job.job_id}"))
        elif job.program == "train":
            findings.extend(_lint_train_job(job, f"{where}:{job.job_id}"))

    # SPEC-007: --comm-quant wire-format validity, statically — the value
    # must parse against the wire-format grammar, and for block formats
    # the block (and the quantized ring's chunking) must divide every
    # payload the job's (mode, size, num_devices) cells imply; at run
    # time that ValueError fires an hour into the sweep
    for job in spec.jobs:
        findings.extend(_comm_quant_findings(job, f"{where}:{job.job_id}"))

    # SPEC-008: the hierarchical-mesh flag family (--mesh, per-link
    # --comm-quant, --stream-k, --mem-budget-gib), same
    # fail-at-lint-not-mid-campaign contract
    for job in spec.jobs:
        findings.extend(_hier_findings(job, f"{where}:{job.job_id}"))

    # SPEC-010: pod serving jobs — replica-group divisibility against
    # the mesh factorization + per-group wire formats over the mix
    for job in spec.jobs:
        if job.program == "serve":
            findings.extend(_pod_findings(job, f"{where}:{job.job_id}"))

    # mesh divisibility: sharding modes need size % num_devices == 0
    for job in spec.jobs:
        argv = list(job.argv)
        modes = _flag_values(argv, "--mode") or []
        if not (_DIVISIBILITY_MODES & set(modes)):
            continue
        devs = _flag_values(argv, "--num-devices")
        sizes = _flag_values(argv, "--sizes")
        for d_str in devs:
            for s_str in sizes:
                try:
                    d, s = int(d_str), int(s_str)
                except ValueError:
                    continue
                if d > 1 and s % d:
                    findings.append(Finding(
                        "SPEC-003", f"{where}:{job.job_id}",
                        f"size {s} not divisible by num_devices {d} for "
                        f"sharding mode(s) {sorted(_DIVISIBILITY_MODES & set(modes))}",
                        details={"size": s, "num_devices": d}))
    return findings


def lint_specs(paths: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for path in paths:
        findings.extend(lint_spec_file(path))
    return findings
