"""Whole dry-run cells of the port beside the reference's
(``test_torch_dryrun_cells*.py``): the port's ``run_cell`` at full config
on a fake world of 256 or 512 ranks against the reference's record of the
same cell (``torch_dryrun_ref``)."""
import json

from repro_torch.launch import dryrun

#: the record's figures held equal; ``collectives`` and ``cost`` are printed
#: beside the reference's: DTensor's redistributions are not GSPMD's, and
#: XLA counts a loop body once
EQUAL = ("arch", "shape", "mesh", "world", "n_params", "kind", "seq_len", "global_batch",
         "overrides", "loops")


def keys(rec):
    """The record's keys, nested dicts' keys under their parent's, the
    collectives' per-op keys left out (which ops appear differs)."""
    out = set()
    for k, v in rec.items():
        out.add(k)
        if isinstance(v, dict) and k not in ("collectives", "overrides"):
            out.update(f"{k}.{kk}" for kk in v)
    return out


def check(cell, ref, monkeypatch):
    """The port's run of ``cell`` held to the reference's record; returns it."""
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    c = dryrun.plan(*cell)
    run = dryrun.dry_run(c)
    got, want = run.record, ref[cell]
    assert keys(got) == keys(want)
    assert {"total_wire_bytes_per_device", "count"} <= set(got["collectives"])
    for k in EQUAL:
        assert got[k] == want[k], k
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    m = got["memory"]
    assert m["per_device_total_bytes"] == (m["argument_bytes"] + m["temp_bytes"]
                                          + m["output_bytes"] - m["alias_bytes"])
    # the arguments no op took are those the reference's compiled step drops
    assert run.unread == dryrun.unread_arguments(c) - {("pos",)}
    print(json.dumps({"cell": cell, "port": {k: got[k] for k in ("memory", "cost", "collectives")},
                      "reference": {k: want[k] for k in ("memory", "cost", "collectives")},
                      "replicated_ops": run.replications}))
    return run
