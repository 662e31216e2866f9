"""The port's quality queue on the card, `results/r6pt_queue.txt`, against
the reference's GAN quality table: every row parses as the runner's
`<tag> | <command>`, has a fresh `pt_` tag, runs the port's quality
protocol (never a root `scripts/` file) and names one reference row with
that row's preset, step count, protocol and seeds, at the preset's own
batch and dtype.  The records the runner wrote, `results/r6pt_results.jsonl`,
are held to the queue they came from.  `results/r7pt_queue.txt` runs the
`stream_v5e8` hard row's seeds 0 and 7 again under torchrun on four cards,
held alike with `results/r7pt_results.jsonl`."""

import _torch_threads  # noqa: F401  (first: the CPU thread budget)

import json
import shlex
from pathlib import Path

import pytest

from gan_sass_tf_tpu_torch.scripts import run_queue

RESULTS = Path(__file__).resolve().parents[1] / "results"
QUEUE = RESULTS / "r6pt_queue.txt"
RECORDS = RESULTS / "r6pt_results.jsonl"
R5_RECORDS = RESULTS / "r5_results.jsonl"
MODULE = "gan_sass_tf_tpu_torch.scripts.quality_protocol"
QUEUE4 = RESULTS / "r7pt_queue.txt"
RECORDS4 = RESULTS / "r7pt_results.jsonl"
TORCHRUN4 = ["python3", "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "4", "-m"]
# The four-card rows: the reference's stream_v5e8 hard row (BASELINE.md:250).
ROWS4 = {"pt4_stream_hard_s07": ("stream_v5e8", 10_000, True, (0, 7))}

# The reference's rows (BASELINE.md, the "with-GAN" column of :678-685 and
# the rows it cites): (preset, steps, hard, seeds) of each queued tag.
# stream_v5e8's reference ran seeds 0 and 7; the port's row adds 3-6 to the
# 0, 1, 2 and 7 measured before.
ROWS = {
    "pt_wsj0_hard": ("wsj0_logmel", 10_000, True, (0, 7)),           # :651, :682
    "pt_wsj0_easy": ("wsj0_logmel", 10_000, False, (0, 7)),          # :648, :681
    "pt_stream_hard_s3456": ("stream_v5e8", 10_000, True, (3, 4, 5, 6)),  # :250, :684
    "pt_3src_hard": ("3src_pit", 5_000, True, (0, 7)),               # :683
    "pt_music_hard": ("music_complex_44k", 10_000, True, (0, 7)),    # :490, :685
}


def _queue():
    return run_queue.parse_queue(str(QUEUE))


def _parse(cmd: str):
    """(module, preset, steps, hard, seeds, other arguments) of a queued
    quality-protocol command."""
    argv = shlex.split(cmd)
    assert argv[:2] in (["python", "-m"], ["python3", "-m"]), cmd
    module, rest = argv[2], argv[3:]
    hard = "--hard" in rest
    rest = [a for a in rest if a != "--hard"]
    i = rest.index("--seeds")
    seeds = tuple(int(s) for s in rest[i + 1].split(","))
    del rest[i:i + 2]
    return module, rest[0], int(rest[1]), hard, seeds, rest[2:]


def test_queue_rows_parse_as_tag_and_command():
    lines = [ln.strip() for ln in QUEUE.read_text().splitlines()]
    rows = [ln for ln in lines if ln and not ln.startswith("#")]
    assert len(rows) == len(_queue()) == len(ROWS)
    for ln in rows:
        tag, sep, cmd = ln.partition(" | ")
        assert sep and tag.strip() == tag and tag and cmd.strip(), ln
    assert [t for t, _ in _queue()] == list(ROWS), "the main path's rows first"


@pytest.mark.parametrize("tag", list(ROWS))
def test_queue_row_is_a_fresh_port_tag(tag):
    assert tag.startswith("pt_")
    r5_tags = {json.loads(ln)["tag"] for ln in R5_RECORDS.read_text().splitlines()
               if ln.strip()}
    assert tag not in r5_tags
    assert tag in dict(_queue())


@pytest.mark.parametrize("tag", list(ROWS))
def test_queue_row_runs_the_ports_protocol_on_its_reference_row(tag):
    cmd = dict(_queue())[tag]
    assert "scripts/" not in cmd and not any(
        a.endswith(".py") for a in shlex.split(cmd)), cmd
    module, preset, steps, hard, seeds, other = _parse(cmd)
    assert module == MODULE
    assert (preset, steps, hard, seeds) == ROWS[tag]
    # The preset's own batch, dtype and step count: no override, no device.
    assert other == [], other


def test_records_hold_the_queue():
    """Every record the runner wrote names a queued tag with its command
    as queued, in the runner's format, and ran to rc 0; no tag twice."""
    records = [json.loads(ln) for ln in RECORDS.read_text().splitlines() if ln.strip()]
    queue = dict(_queue())
    assert [r["tag"] for r in records] == list(dict.fromkeys(r["tag"] for r in records))
    for r in records:
        assert set(r) >= {"tag", "cmd", "rc", "wall_s", "result"}, r
        assert r["cmd"] == queue[r["tag"]] and r["rc"] == 0, r
        preset, steps, hard, seeds = ROWS[r["tag"]]
        res = r["result"]
        assert (res["preset"], res["steps"], res["hard"], tuple(res["seeds"])) == (
            preset, steps, hard, seeds), r
        assert len(res["si_sdr_improvement_per_seed"]) == len(seeds)


def test_four_card_queue_rows_run_the_protocol_under_torchrun():
    """r7pt: each row a fresh tag (in no other round's records) and the
    port's protocol on its reference row, launched by torchrun at four
    ranks on one host, at the preset's own global batch (no override)."""
    queue = run_queue.parse_queue(str(QUEUE4))
    assert [t for t, _ in queue] == list(ROWS4)
    other = {json.loads(ln)["tag"] for f in (R5_RECORDS, RECORDS)
             for ln in f.read_text().splitlines() if ln.strip()}
    for tag, cmd in queue:
        assert tag.startswith("pt4_") and tag not in other and tag not in ROWS
        argv = shlex.split(cmd)
        assert argv[:len(TORCHRUN4)] == TORCHRUN4, cmd
        module, preset, steps, hard, seeds, rest = _parse(
            "python3 -m " + shlex.join(argv[len(TORCHRUN4):]))
        assert module == MODULE and rest == []
        assert (preset, steps, hard, seeds) == ROWS4[tag]


def test_four_card_records_hold_the_queue():
    """Every r7pt record names its queued row with the command as queued,
    ran to rc 0 and reports the row's preset, steps, protocol and seeds."""
    records = [json.loads(ln) for ln in RECORDS4.read_text().splitlines() if ln.strip()]
    queue = dict(run_queue.parse_queue(str(QUEUE4)))
    assert records and [r["tag"] for r in records] == list(
        dict.fromkeys(r["tag"] for r in records))
    for r in records:
        assert r["cmd"] == queue[r["tag"]] and r["rc"] == 0, r
        res = r["result"]
        assert (res["preset"], res["steps"], res["hard"], tuple(res["seeds"])) == \
            ROWS4[r["tag"]], r
        assert len(res["si_sdr_improvement_per_seed"]) == len(ROWS4[r["tag"]][3])
