"""The port's schema-flow certifier (`tpu_matmul_bench_torch/analysis/
schema_flow.py`) against the JAX package's.

Each of JAX's seeded fixtures, broken and repaired, goes through both
certifiers with the same family table and must give the same findings; the
port's own package must certify clean with a live declaration table, and
its scan must stay inside the port's package.
"""

import dataclasses

import pytest

from tpu_matmul_bench.analysis import schema_flow as jax_schema
from tpu_matmul_bench_torch.analysis import schema_flow as schema


def _port_table(families):
    return {name: schema.Family(**dataclasses.asdict(fam)) for name, fam in families.items()}


def _write(tmp_path, rule, sources):
    root = tmp_path / rule.lower()
    root.mkdir()
    merged = dict(sources)
    for name, extra in jax_schema._FIXTURE_EXTRA.get(rule, {}).items():
        merged[name] = merged.get(name, "") + extra
    for name, src in merged.items():
        (root / name).write_text(src)
    return root


_IDS = [f[0] for f in jax_schema._SELFTEST_FIXTURES]


@pytest.mark.parametrize("which", ["broken", "repaired"])
@pytest.mark.parametrize("rule,sources,broken,repaired", jax_schema._SELFTEST_FIXTURES,
                         ids=_IDS)
def test_seeded_fixtures_match_jax(tmp_path, rule, sources, broken, repaired, which):
    root = _write(tmp_path, rule, sources)
    table = broken if which == "broken" else repaired
    port = schema.schema_findings(root, families=_port_table(table))
    ref = jax_schema.schema_findings(root, families=table)
    assert [f.to_record() for f in port] == [f.to_record() for f in ref]
    if which == "broken":
        assert rule in {f.rule for f in port}
    else:
        assert port == []


def test_port_tree_is_clean_and_deterministic():
    first = schema.schema_findings()
    assert first == []  # warnings included: OUTPUT_ONLY entries carry reasons
    assert [f.to_record() for f in schema.schema_findings()] == \
        [f.to_record() for f in first]


def test_declaration_table_is_live():
    assert schema.declaration_problems() == []


def test_families_are_jax_s_and_every_reason_is_written():
    assert set(schema.RECORD_FAMILIES) == set(jax_schema.RECORD_FAMILIES)
    for name, fam in schema.RECORD_FAMILIES.items():
        for table in (fam.output_only, fam.historical):
            assert all(isinstance(r, str) and r.strip() for r in table.values()), name
        assert fam.ingest is not None or fam.non_history, name


def test_scan_stays_in_the_port_package():
    files = schema._scan_files(None)
    assert files and all(path.is_relative_to(schema._package_root()) for _, path in files)
    rels = {rel for rel, _ in files}
    assert "bench.py" in rels  # the port's own round driver
    assert not any(rel.startswith("scripts/") for rel in rels)


def test_writer_registry_ties_to_the_families():
    tree = schema._index_tree(None)
    assert "tune/artifacts.py" in tree.writer_registry
    assert tree.write_raw_sites == [("serve/service.py::_worker_drain",
                                     tree.write_raw_sites[0][1])]


def test_selftest_passes(capsys):
    assert schema.run_schema_selftest() == []
    assert "schema selftest ok" in capsys.readouterr().out


def test_a_key_nobody_reads_is_a_warning_until_declared(tmp_path):
    # the port's form of a JAX consumer with no counterpart: the key is a
    # SCHEMA-003 warning, or an output-only entry with a reason
    root = tmp_path / "t"
    root.mkdir()
    (root / "p.py").write_text("def make():\n    return {'alpha': 1, 'digest_only': 2}\n")
    (root / "c.py").write_text("def read(rec):\n    return rec['alpha']\n")
    fam = schema.Family(producers=("p.py::make",), consumers=("c.py::read",), durable=False)
    found = schema.schema_findings(root, families={"demo": fam})
    assert [(f.rule, f.severity, f.details["key"]) for f in found] == \
        [("SCHEMA-003", "warn", "digest_only")]
    declared = dataclasses.replace(fam, output_only={"digest_only": "read by humans"})
    assert schema.schema_findings(root, families={"demo": declared}) == []
