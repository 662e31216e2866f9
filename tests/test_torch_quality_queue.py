"""The port's quality queue on the card, `results/r6pt_queue.txt`, against
the reference's GAN quality table: every row parses as the runner's
`<tag> | <command>`, has a fresh `pt_` tag, runs the port's quality
protocol (never a root `scripts/` file) and names one reference row with
that row's preset, step count, protocol and seeds, at the preset's own
batch and dtype.  The records the runner wrote, `results/r6pt_results.jsonl`,
are held to the queue they came from.  `results/r7pt_queue.txt` runs the
`stream_v5e8` hard row's seeds 0 and 7 again under torchrun on four cards,
held alike with `results/r7pt_results.jsonl`.  `results/r8pt_queue.txt`
carries the reference's other recorded rows (the bench's batch, the adv=0
controls, the wsj0 revival levers) over from `results/r5_queue.txt`, each
with its r5 row's preset, steps, protocol, seeds and `--set` overrides,
and is held alike with `results/r8pt_results.jsonl`.  `results/r9pt_queue.txt`
runs the port's `stream_quality` on the reference's r5 stream rows (each
naming the chaining hysteresis its source ran at, whatever today's default),
the presets' shipped easy rows of `BASELINE.md` and further r5 rows, held
alike with `results/r9pt_results.jsonl`."""

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


QUEUE8 = RESULTS / "r8pt_queue.txt"
RECORDS8 = RESULTS / "r8pt_results.jsonl"
R5_QUEUE = RESULTS / "r5_queue.txt"
R5_SCRIPT = ["python", "scripts/quality_protocol.py"]
# Each r8pt tag and the r5 row it carries over (results/r5_queue.txt line),
# in the queue's order: the bench's batch first (BASELINE.md:649,652), the
# adv=0 controls (:678-684), the wsj0 revival levers (:700-703).
ROWS8 = {
    "pt_wsj0_b128_hard": "d_wsj0_b128_hard",        # :66
    "pt_wsj0_b128_easy": "d_wsj0_b128_easy",        # :65
    "pt_stream_adv0_hard": "b_stream_adv0_hard",    # :55
    "pt_wsj0_adv0_hard": "b_wsj0_adv0_hard",        # :53
    "pt_3src_adv0_hard": "b_3src_adv0_hard",        # :54
    "pt_wsj0_r1_hard": "c_wsj0_r1_hard",            # :59
    "pt_wsj0_dlrcos_hard": "c_wsj0_dlrcos_hard",    # :60
    "pt_wsj0_r1_bnD_hard": "c_wsj0_r1_bnD_hard",    # :61
    "pt_wsj0_weakD_hard": "c_wsj0_weakD_hard",      # :62
}


def _args(argv):
    """(preset, steps, hard, seeds, --set overrides, anything else) of a
    quality-protocol command's arguments."""
    rest, sets = [a for a in argv if a != "--hard"], []
    while "--set" in rest:
        i = rest.index("--set")
        sets.append(rest[i + 1])
        del rest[i:i + 2]
    i = rest.index("--seeds")
    seeds = tuple(int(s) for s in rest[i + 1].split(","))
    del rest[i:i + 2]
    return rest[0], int(rest[1]), "--hard" in argv, seeds, sets, rest[2:]


def _r5_argv(tag):
    """The r5 row's command, its `timeout` prefix taken off."""
    argv = shlex.split(dict(run_queue.parse_queue(str(R5_QUEUE)))[tag])
    assert argv[:2] == ["timeout", "5400"], argv
    return argv[2:]


def _r5_row(tag):
    """The r5 row's arguments, its `timeout` prefix and root script taken
    off."""
    argv = _r5_argv(tag)
    assert argv[:2] == R5_SCRIPT, argv
    return _args(argv[2:])


def _r8_row(tag):
    argv = shlex.split(dict(run_queue.parse_queue(str(QUEUE8)))[tag])
    assert argv[:3] == ["python3", "-m", MODULE], argv
    return _args(argv[3:])


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


def test_r8pt_rows_parse_as_tag_and_command_in_order():
    lines = [ln.strip() for ln in QUEUE8.read_text().splitlines()]
    rows = [ln for ln in lines if ln and not ln.startswith("#")]
    for ln in rows:
        tag, sep, cmd = ln.partition(" | ")
        assert sep and tag.strip() == tag and tag and cmd.strip(), ln
    assert [t for t, _ in run_queue.parse_queue(str(QUEUE8))] == list(ROWS8)


@pytest.mark.parametrize("tag", list(ROWS8))
def test_r8pt_row_is_a_fresh_port_tag(tag):
    assert tag.startswith("pt_")
    other = {r["tag"] for f in (R5_RECORDS, RECORDS, RECORDS4) for r in _records(f)}
    assert tag not in other and tag not in ROWS and tag not in ROWS4


@pytest.mark.parametrize("tag", list(ROWS8))
def test_r8pt_row_carries_its_r5_row_over(tag):
    """The port's protocol by module, no `.py` path, and the r5 row's
    preset, steps, protocol, seeds and overrides letter for letter; that
    r5 row ran to rc 0."""
    cmd = dict(run_queue.parse_queue(str(QUEUE8)))[tag]
    assert "scripts/" not in cmd and not any(
        a.endswith(".py") for a in shlex.split(cmd)), cmd
    ours, ref = _r8_row(tag), _r5_row(ROWS8[tag])
    assert ours == ref and ours[5] == [], (ours, ref)
    assert "--device" not in cmd
    r5 = [r for r in _records(R5_RECORDS) if r["tag"] == ROWS8[tag]]
    assert any(r["rc"] == 0 and r["result"] for r in r5), ROWS8[tag]


@pytest.mark.parametrize("tag", list(ROWS8))
def test_r8pt_record_holds_its_queued_row(tag):
    """One record for the row, in the runner's format, with the command
    as queued, rc 0 and the row's preset, steps, protocol and seeds."""
    records = [r for r in _records(RECORDS8) if r["tag"] == tag]
    assert len(records) == 1, tag
    r = records[0]
    assert set(r) >= {"tag", "cmd", "rc", "wall_s", "result"}, r
    assert r["cmd"] == dict(run_queue.parse_queue(str(QUEUE8)))[tag] and r["rc"] == 0, r
    preset, steps, hard, seeds, _, _ = _r8_row(tag)
    res = r["result"]
    assert (res["preset"], res["steps"], res["hard"], tuple(res["seeds"])) == (
        preset, steps, hard, seeds), r
    assert len(res["si_sdr_improvement_per_seed"]) == len(seeds)


def test_r8pt_records_name_only_queued_rows():
    assert {r["tag"] for r in _records(RECORDS8)} <= set(ROWS8)


QUEUE9 = RESULTS / "r9pt_queue.txt"
RECORDS9 = RESULTS / "r9pt_results.jsonl"
BASELINE = RESULTS.parent / "BASELINE.md"
STREAM_MODULE = "gan_sass_tf_tpu_torch.scripts.stream_quality"
R5_STREAM_SCRIPT = ["python", "scripts/stream_quality.py"]
# Each r9pt tag and its source, in the queue's order: an r5 row
# (results/r5_queue.txt line) or a BASELINE.md table line with the
# (preset, steps, hard, seeds) the port runs it at.  The stream rows first
# (the serving path on a trained G), then the presets' shipped easy rows,
# then ROADMAP item 11's next r5 rows.
ROWS9 = {
    "pt_stream_quality_hyst": "e_stream_hard_hyst_v2",          # :79
    "pt_stream_quality_argmin": "e_stream_hard_nohyst_v2",      # :80
    "pt_stream_quality_argmin_s1": "z_stream_hard_argmin_s1",   # :129
    "pt_stream_quality_hyst_s1": "z_stream_hard_hyst_s1",       # :130
    "pt_3src_easy": (261, ("3src_pit", 5_000, False, (0, 7))),
    "pt_stream_easy": (247, ("stream_v5e8", 10_000, False, (0, 7))),
    "pt_music_easy": (266, ("music_complex_44k", 10_000, False, (0, 7))),
    "pt_toy_easy": (244, ("2src_toy_cpu", 10_000, False, (0, 7))),
    "pt_toy_hard": (245, ("2src_toy_cpu", 10_000, True, (0, 7))),
    "pt_wsj0_b128_lrsqrt_easy": "d_wsj0_b128_lrsqrt_easy",      # :72
    "pt_3src_conv_easy": "g_3src_conv_easy",                    # :92
    "pt_3src_conv_hard": "g_3src_conv_hard",                    # :93
    "pt_3src_wide_easy": "g_3src_wide_easy",                    # :94
}
STREAM9 = [t for t, src in ROWS9.items() if str(src).startswith(("e_stream", "z_stream"))]
HYSTERESIS = "stream.perm_hysteresis"


def _stream_args(argv):
    """(steps, seed, hard, {--set key: value}, anything else) of a
    stream-quality command's arguments."""
    rest, sets, seed = list(argv), {}, 0
    while "--set" in rest:
        i = rest.index("--set")
        key, _, val = rest[i + 1].partition("=")
        sets[key] = val
        del rest[i:i + 2]
    if "--seed" in rest:
        i = rest.index("--seed")
        seed = int(rest[i + 1])
        del rest[i:i + 2]
    hard = "--easy" not in rest
    rest = [a for a in rest if a != "--easy"]
    return int(rest[0]), seed, hard, sets, rest[1:]


def _r9_argv(tag):
    return shlex.split(dict(run_queue.parse_queue(str(QUEUE9)))[tag])


def _source_hysteresis(r5_tag):
    """The hysteresis the r5 stream row ran at: its record's, else its
    command's explicit `--set`, else the JAX config's default (the row was
    queued after the default became 0)."""
    from gan_sass_tf_tpu.config import StreamConfig

    recs = [r for r in _records(R5_RECORDS) if r["tag"] == r5_tag and r["result"]]
    if recs:
        return float(recs[0]["result"]["perm_hysteresis"])
    sets = _stream_args(_r5_argv(r5_tag)[2:])[3]
    return float(sets.get(HYSTERESIS, StreamConfig().perm_hysteresis))


def test_r9pt_rows_parse_as_tag_and_command_in_order():
    lines = [ln.strip() for ln in QUEUE9.read_text().splitlines()]
    rows = [ln for ln in lines if ln and not ln.startswith("#")]
    for ln in rows:
        tag, sep, cmd = ln.partition(" | ")
        assert sep and tag.strip() == tag and tag and cmd.strip(), ln
    assert [t for t, _ in run_queue.parse_queue(str(QUEUE9))] == list(ROWS9)


@pytest.mark.parametrize("tag", list(ROWS9))
def test_r9pt_row_is_a_fresh_port_tag(tag):
    assert tag.startswith("pt_")
    other = {r["tag"] for f in (R5_RECORDS, RECORDS, RECORDS4, RECORDS8)
             for r in _records(f)}
    assert tag not in other and tag not in ROWS and tag not in ROWS4 and tag not in ROWS8


@pytest.mark.parametrize("tag", list(ROWS9))
def test_r9pt_row_runs_a_port_module(tag):
    """A port module by `python3 -m`, no root script or `.py` path, and on
    the card (no `--device`)."""
    argv = _r9_argv(tag)
    assert argv[:2] == ["python3", "-m"], argv
    assert argv[2] == (STREAM_MODULE if tag in STREAM9 else MODULE), argv
    assert not any("scripts/" in a or a.endswith(".py") for a in argv), argv
    assert "--device" not in argv


@pytest.mark.parametrize("tag", list(ROWS9))
def test_r9pt_row_carries_its_source_over(tag):
    """An r5 row's preset, steps, protocol, seeds and `--set` overrides
    letter for letter (a stream row also names its hysteresis, which must
    be the one its source ran at); a BASELINE.md row's preset, steps and
    protocol as that table line states them, at seeds 0 and 7 and with no
    override.  An r5 source ran to rc 0 where it has a record."""
    argv, src = _r9_argv(tag), ROWS9[tag]
    if tag in STREAM9:
        ref = _r5_argv(src)
        assert ref[:2] == R5_STREAM_SCRIPT, ref
        steps, seed, hard, sets, other = _stream_args(argv[3:])
        r_steps, r_seed, r_hard, r_sets, r_other = _stream_args(ref[2:])
        assert (steps, seed, hard, other) == (r_steps, r_seed, r_hard, r_other) and other == []
        assert float(sets.pop(HYSTERESIS)) == _source_hysteresis(src)
        r_sets.pop(HYSTERESIS, None)
        assert sets == r_sets
    elif isinstance(src, str):
        ours, ref = _args(argv[3:]), _r5_row(src)
        assert ours == ref and ours[5] == [], (ours, ref)
    else:
        line_no, (preset, steps, hard, seeds) = src
        line = BASELINE.read_text().splitlines()[line_no - 1]
        cells = [c.strip() for c in line.split("|")]
        assert cells[1].startswith(f"`{preset}`"), line
        assert cells[2] == ("hard" if hard else "easy"), line
        assert cells[3] == f"{steps // 1000}k", line
        assert "seeds" not in line or "seeds 0/7" in line, line
        assert _args(argv[3:]) == (preset, steps, hard, seeds, [], [])
    if isinstance(src, str):
        r5 = [r for r in _records(R5_RECORDS) if r["tag"] == src]
        assert all(r["rc"] == 0 and r["result"] for r in r5), src


@pytest.mark.parametrize("tag", list(ROWS9))
def test_r9pt_record_holds_its_queued_row(tag):
    """One record for the row, in the runner's format, with the command as
    queued, rc 0 and the row's own arguments in its result: preset, steps,
    protocol and seeds, or a stream row's seed, the 17.75 s stream of its
    source and the hysteresis it queued."""
    records = [r for r in _records(RECORDS9) if r["tag"] == tag]
    assert len(records) == 1, tag
    r = records[0]
    assert set(r) >= {"tag", "cmd", "rc", "wall_s", "result"}, r
    assert r["cmd"] == dict(run_queue.parse_queue(str(QUEUE9)))[tag] and r["rc"] == 0, r
    res, argv = r["result"], _r9_argv(tag)
    if tag in STREAM9:
        steps, seed, hard, sets, _ = _stream_args(argv[3:])
        assert (res["preset"], res["steps"], res["seed"], res["hard"]) == (
            "stream_v5e8", steps, seed, hard), r
        assert res["stream_seconds"] == 17.75, r
        assert res["perm_hysteresis"] == float(sets[HYSTERESIS]), r
    else:
        preset, steps, hard, seeds, _, _ = _args(argv[3:])
        assert (res["preset"], res["steps"], res["hard"], tuple(res["seeds"])) == (
            preset, steps, hard, seeds), r
        assert len(res["si_sdr_improvement_per_seed"]) == len(seeds)


@pytest.mark.parametrize("tag", STREAM9)
def test_r9pt_stream_record_runs_at_its_sources_hysteresis(tag):
    """The default-flip guard: a stream record's `perm_hysteresis` is the
    one its source ran at (the r5 record's, or the r5 command's explicit
    `--set`), not whatever the default is now."""
    (r,) = [r for r in _records(RECORDS9) if r["tag"] == tag]
    assert r["result"]["perm_hysteresis"] == _source_hysteresis(ROWS9[tag])


def test_r9pt_records_name_only_queued_rows():
    assert {r["tag"] for r in _records(RECORDS9)} <= set(ROWS9)
