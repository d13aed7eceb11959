"""The port's analysis subcommands (``analyze``, ``scan``, ``compare``,
``pulse``, ``risk``, ``doctor``, ``setup``) against the JAX package's
``openintel`` on the offline fixtures.

The same argv goes to both CLIs (the port's with ``--device cpu`` where
the command takes it): the exit code, the error text and the output are
the reference's. JSON is compared field by field: integers, strings and
codes equal, floats within 1e-6 (both packages aggregate a scan in f32,
XLA on the CPU against torch), the clock fields ``generated_at`` dropped
on both sides (each CLI reads its own clock); table text is compared line
for line, the ``generated:`` line aside. With a trained analyzer
(``analyze --analyzer``, one checkpoint for both CLIs) floats agree within
1e-5, the neural analyzer's rule (its encoders sum in other orders).
Without a card and without ``--device cpu``, a command that runs a device
program fails with CUDA's own error and ``doctor`` exits 1. Every test of
``tests/test_cli.py``'s analysis cases has a counterpart here; the
network is never touched (the X feed and the setup probes are
monkeypatched).
"""

import json

import pytest
import torch

from openintel_tpu.cli import main as jcli
from openintel_tpu.cli import setup as jsetup
from openintel_tpu.sources import x as jx
from openintel_tpu_torch.cli import main as tcli
from openintel_tpu_torch.cli import setup as tsetup
from openintel_tpu_torch.sources import x as tx

from torch_analysis_utils import ENV, FLOAT_TOL, assert_json_close, drop_clock

ANALYZER_TOL = 1e-5
DEVICE_COMMANDS = ("analyze", "scan", "compare", "risk", "doctor")


@pytest.fixture(autouse=True)
def no_credentials(monkeypatch):
    """No test depends on the host's credentials."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


def _run(capsys, main, argv):
    code = main(list(argv))
    captured = capsys.readouterr()
    return captured.out, captured.err, code


def port(capsys, *argv):
    argv = list(argv)
    if argv[0] in DEVICE_COMMANDS:
        argv += ["--device", "cpu"]
    return _run(capsys, tcli.main, argv)


def ref(capsys, *argv):
    return _run(capsys, jcli.main, argv)


def table_lines(out):
    return [ln for ln in out.splitlines() if not ln.startswith("generated: ")]


def assert_same(capsys, argv, tol=FLOAT_TOL):
    """One argv through both CLIs: exit codes equal, JSON close, tables
    and error texts equal. Returns the port's output."""
    t_out, _, t_code = port(capsys, *argv)
    j_out, _, j_code = ref(capsys, *argv)
    assert t_code == j_code, (t_out, j_out)
    if "json" in argv and t_code == 0:
        assert_json_close(drop_clock(json.loads(t_out)), drop_clock(json.loads(j_out)), tol)
    else:
        assert table_lines(t_out) == table_lines(j_out)
    return t_out, t_code


# ---------- analyze ----------


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_analyze_offline_matches_the_reference(capsys, fmt):
    out, code = assert_same(capsys, ["analyze", "AAPL", "--offline", "--format", fmt])
    assert code == 0
    if fmt == "table":
        for line in ("=== OpenIntel — AAPL ===", "mentions: 10 (bull 7 / bear 2 / neutral 1)",
                     "net sentiment: +0.50", "speculation index: 30%",
                     "alignment: confirming_bullish", "crowding: 50%", "Not financial advice"):
            assert line in out
    else:
        doc = json.loads(out)
        assert doc["social"]["total_mentions"] == 10
        assert doc["fusion"]["alignment"] == "confirming_bullish"
        assert abs(doc["fusion"]["crowding"] - 0.49669) < 1e-3
        assert doc["social"]["mentions_by_source"] == {"bluesky": 6, "reddit": 4}


@pytest.mark.parametrize(
    "flags",
    [["--reddit"], ["--bluesky"], ["--no-market"], ["--limit", "3"], ["--reddit", "--bluesky", "--no-market"]],
)
@pytest.mark.parametrize("fmt", ["table", "json"])
def test_analyze_source_flags_match_the_reference(capsys, flags, fmt):
    out, code = assert_same(capsys, ["analyze", "AAPL", "--offline", *flags, "--format", fmt])
    assert code == 0
    if flags == ["--reddit"] and fmt == "json":
        assert json.loads(out)["social"]["total_mentions"] == 4
    if flags == ["--no-market"]:
        assert ("(disabled)" in out) if fmt == "table" else json.loads(out)["fusion"]["alignment"] == "quiet"


def test_analyze_bad_ticker_matches_the_reference(capsys):
    out, code = assert_same(capsys, ["analyze", "$$$", "--offline"])
    assert code == 1 and "invalid ticker" in out


@pytest.fixture(scope="module")
def analyzer_ck(tmp_path_factory):
    """An analyzer head distilled by the port's ``train --analyzer`` at a
    tiny width; the reference's ``load_analyzer`` reads it."""
    d = tmp_path_factory.mktemp("analyzer")
    corpus = d / "c.txt"
    corpus.write_text("AAPL to the moon calls\nbuying puts dump\nflat day\nrocket squeeze\n" * 4)
    code = tcli.main(["train", str(corpus), "--out", str(d / "ck"), "--dim", "16", "--depth", "1",
                      "--heads", "2", "--steps", "2", "--batch-size", "4", "--analyzer",
                      "--device", "cpu"])
    assert code == 0
    return str(d / "ck")


def test_analyze_with_a_trained_analyzer_matches_the_reference(capsys, analyzer_ck):
    assert_same(capsys, ["analyze", "TSLA", "--offline", "--analyzer", analyzer_ck, "--format", "json"],
                tol=ANALYZER_TOL)
    assert_same(capsys, ["analyze", "TSLA", "--offline", "--analyzer", analyzer_ck, "--no-market"])


# ---------- scan and compare ----------


@pytest.mark.parametrize("fmt", ["table", "json"])
def test_scan_offline_matches_the_reference(capsys, fmt):
    out, code = assert_same(capsys, ["scan", "AAPL", "TSLA", "MSFT", "$$$", "--offline", "--format", fmt])
    assert code == 0
    if fmt == "table":
        assert "AAPL: confirming_bullish" in out and "TSLA: confirming_bullish" in out
        assert "$$$: error" in out
    else:
        assert [e["ticker"] for e in json.loads(out)["entries"]] == ["AAPL", "TSLA", "MSFT", "$$$"]


@pytest.mark.parametrize("rank_by", ["crowding", "speculation_index", "net_sentiment", "divergence"])
@pytest.mark.parametrize("fmt", ["table", "json"])
@pytest.mark.parametrize("market", [[], ["--no-market"]], ids=["market", "no-market"])
def test_compare_offline_matches_the_reference(capsys, rank_by, fmt, market):
    out, code = assert_same(capsys, ["compare", "AAPL", "MSFT", "$$$", "--offline", "--format", fmt,
                                     "--rank-by", rank_by, *market])
    assert code == 0
    if fmt == "json":
        doc = json.loads(out)
        assert doc["rank_by"] == rank_by and len(doc["ranked"]) == 2
        assert doc["errors"][0]["ticker"] == "$$$"
        if rank_by == "net_sentiment":
            assert doc["ranked"][0]["rank_metric"] == pytest.approx(0.5)


# ---------- risk ----------


@pytest.mark.parametrize("fmt", ["table", "json"])
@pytest.mark.parametrize("flags", [[], ["--direction", "short", "--stop-multiple", "3"], ["--entry", "110"]])
def test_risk_offline_matches_the_reference(capsys, fmt, flags):
    out, code = assert_same(capsys, ["risk", "NVDA", "--budget", "200", "--offline", "--format", fmt, *flags])
    assert code == 0
    if not flags and fmt == "json":
        doc = json.loads(out)
        assert doc["atr"] == pytest.approx(4.0) and doc["stop"] == pytest.approx(98.0)
        assert doc["shares"] == 25 and doc["max_loss_usd"] == pytest.approx(200.0)
        assert doc["targets"] == [114.0, 122.0, 130.0] and "calculator" in doc["framing"]
    if not flags and fmt == "table":
        assert "stop: 98.00" in out and "a calculator, not advice" in out


@pytest.mark.parametrize(
    "argv",
    [
        ["risk", "NVDA", "AMD", "--budget", "200", "--offline"],
        ["risk", "NVDA", "AMD", "$$$", "--budget", "200", "--offline", "--format", "json"],
        ["risk", "NVDA", "AMD", "--budget", "200", "--offline", "--direction", "short"],
        ["risk", "NVDA", "AMD", "--budget", "200", "--offline", "--entry", "100"],
        ["risk", "NVDA", "--budget", "-1", "--offline"],
    ],
    ids=["screen", "screen-json", "screen-short", "screen-entry", "bad-budget"],
)
def test_risk_screen_matches_the_reference(capsys, argv):
    out, code = assert_same(capsys, argv)
    if argv[-1] == "100":
        assert code == 1 and "--entry only applies" in out
    elif "json" in argv:
        doc = json.loads(out)
        assert [d["ticker"] for d in doc] == ["NVDA", "AMD", "$$$"] and doc[0]["atr"] == pytest.approx(4.0)
    elif argv[2] == "AMD" and argv[-1] == "--offline":
        assert "NVDA: entry 106.00  stop 98.00" in out and "AMD: entry 106.00  stop 98.00" in out
        assert "a calculator, not advice" in out


def test_risk_over_many_tickers_matches_the_reference(capsys):
    """A screen of 64 tickers: one ATR call for the list (on the card by
    default; here ``--device cpu``)."""
    tickers = [f"T{chr(65 + i // 26)}{chr(65 + i % 26)}" for i in range(64)]
    out, code = assert_same(capsys, ["risk", *tickers, "--budget", "500", "--offline", "--format", "json"])
    assert code == 0 and len(json.loads(out)) == 64


# ---------- pulse ----------


def test_pulse_not_configured_matches_the_reference(capsys):
    t_out, t_err, t_code = port(capsys, "pulse", "TSLA")
    j_out, j_err, j_code = ref(capsys, "pulse", "TSLA")
    assert (t_out, t_code) == (j_out, j_code) and t_code == 1 and "not configured" in t_out
    assert t_err == j_err


class CannedFeed:
    """An X feed that reads nothing: two posts 3 hours and 2 days before
    ``now``."""

    def __init__(self, entities, now):
        self.ent, self.now = entities, now

    async def pulse(self, ticker, accounts, keywords, hours_back, limit):
        import datetime as dt

        now, ent = self.now, self.ent
        posts = [
            ent.PulsePost(id="1", author="elonmusk", text=ent.PostText.parse(f"{ticker.as_str()} ships"),
                          created_at=now - dt.timedelta(hours=3, minutes=5), engagement=42),
            ent.PulsePost(id="2", author="a", text=ent.PostText.parse("macro"),
                          created_at=now - dt.timedelta(days=2, minutes=5), engagement=0),
        ][:limit]
        return ent.PulseFetch(posts=posts, posts_returned=12)


@pytest.mark.parametrize(
    "argv",
    [
        ["pulse", "TSLA", "--accounts", "@elonmusk", "--keywords", "Tesla"],
        ["pulse", "NVDA", "--format", "json", "--hours", "500", "--limit", "1"],
        ["pulse", "NVDA", "--accounts", "bad handle!"],
        ["pulse", "$$$"],
    ],
    ids=["table", "json-clamped", "bad-accounts", "bad-ticker"],
)
def test_pulse_with_a_bearer_matches_the_reference(capsys, monkeypatch, argv):
    import datetime as dt

    from openintel_tpu.domain import entities as jent
    from openintel_tpu_torch.domain import entities as tent

    now = dt.datetime.now(dt.timezone.utc)
    monkeypatch.setenv("OPENINTEL_X_BEARER", "token")
    monkeypatch.setattr(tx, "XPulseSource", lambda bearer: CannedFeed(tent, now))
    monkeypatch.setattr(jx, "XPulseSource", lambda bearer: CannedFeed(jent, now))
    out, code = assert_same(capsys, argv)
    if argv[-1] == "Tesla":
        assert code == 0 and "@elonmusk · 3h ago · ♥42" in out and "posts billed: 12" in out


# ---------- doctor ----------


def _index(tmp_path, capsys):
    corpus = tmp_path / "c.txt"
    corpus.write_text("quick brown fox\nlazy dogs sleep\nfox dog fox\n")
    port(capsys, "index", str(corpus), "--out", str(tmp_path / "idx"), "--dim", "32")
    return str(tmp_path / "idx")


def test_doctor_reports_the_environment(tmp_path, capsys):
    out, _, code = port(capsys, "doctor")
    assert code == 0
    for needle in ("openintel-tpu-torch", "torch", "native tier", "CUDA kernels", "nvcc",
                   "default dense kernel", "status: ok"):
        assert needle in out
    idx = _index(tmp_path, capsys)
    out, _, code = port(capsys, "doctor", "--index", idx)
    j_out, _, j_code = ref(capsys, "doctor", "--index", idx)
    assert code == j_code == 0
    line = [ln for ln in out.splitlines() if ln.startswith("index ")]
    assert line == [ln for ln in j_out.splitlines() if ln.startswith("index ")]
    assert "3 docs" in line[0] and "32d" in line[0] and "— OK" in line[0]
    out, _, code = port(capsys, "doctor", "--index", str(tmp_path / "nope"))
    assert code == 1 and "INVALID" in out and "status: problems found" in out


def test_doctor_names_the_reference_mismatches(tmp_path, capsys):
    idx = _index(tmp_path, capsys)
    meta = json.loads((tmp_path / "idx.meta.json").read_text())
    meta["dense_store"] = "bf16"
    (tmp_path / "idx.meta.json").write_text(json.dumps(meta))
    out, _, code = port(capsys, "doctor", "--index", idx)
    j_out, _, j_code = ref(capsys, "doctor", "--index", idx)
    assert code == j_code == 1
    mismatch = [ln for ln in out.splitlines() if "MISMATCH" in ln]
    assert mismatch and mismatch == [ln for ln in j_out.splitlines() if "MISMATCH" in ln]


def test_doctor_reads_the_libraries_and_builds_nothing(tmp_path, capsys, monkeypatch):
    """The native tier's three states and the kernel library's two, read
    from the build directory; no build runs."""
    from openintel_tpu_torch import native
    from openintel_tpu_torch.ops import _kernels

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "libopenintel_native_current.so")
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "library_path", lambda flags=(): tmp_path / "libkernels.so")
    monkeypatch.setattr(_kernels, "build", lambda *a: pytest.fail("doctor built the kernels"))
    out, _, _ = port(capsys, "doctor")
    assert "native tier: NOT built" in out and "CUDA kernels: NOT built" in out
    (tmp_path / "libopenintel_native_older.so").write_bytes(b"")
    (tmp_path / "libkernels.so").write_bytes(b"")
    out, _, code = port(capsys, "doctor")
    assert "native tier: STALE" in out and "CUDA kernels: built and current (libkernels.so)" in out
    assert code == 0 and sorted(p.name for p in tmp_path.iterdir()) == [
        "libkernels.so", "libopenintel_native_older.so"]


def test_doctor_without_a_card_is_a_problem(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out, _, code = _run(capsys, tcli.main, ["doctor"])
    assert code == 1 and "NO card" in out and "status: problems found" in out


# ---------- no fallback ----------


@pytest.mark.parametrize(
    "argv",
    [
        ["scan", "AAPL", "TSLA", "--offline"],
        ["compare", "AAPL", "TSLA", "--offline"],
        ["risk", "NVDA", "AMD", "--budget", "200", "--offline"],
    ],
    ids=["scan", "compare", "risk-screen"],
)
def test_device_commands_run_on_the_card_unless_asked(capsys, argv):
    """Without ``--device cpu`` these go to the card; with no card they
    fail with CUDA's own error, never quietly on the CPU. A one-ticker
    ``risk`` and ``analyze`` below 512 posts are host work, as in the
    reference."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        tcli.main(argv)
    _, _, code = _run(capsys, tcli.main, ["risk", "NVDA", "--budget", "200", "--offline"])
    assert code == 0
    _, _, code = _run(capsys, tcli.main, ["analyze", "AAPL", "--offline"])
    assert code == 0


def test_analyze_with_an_analyzer_runs_on_the_card_unless_asked(analyzer_ck):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        tcli.main(["analyze", "AAPL", "--offline", "--analyzer", analyzer_ck])


# ---------- setup ----------


async def _found(*args):
    return 3


async def _unauthorized(*args):
    raise RuntimeError("token request failed (HTTP 401)")


@pytest.mark.parametrize(
    "argv,env,probe",
    [
        (["setup", "reddit"], {}, None),
        (["setup", "x"], {}, None),
        (["setup", "bluesky"], {"OPENINTEL_BLUESKY_HANDLE": "me.bsky.social"}, None),
        (["setup", "reddit", "--verify"], {"OPENINTEL_REDDIT_CLIENT_ID": "i",
                                           "OPENINTEL_REDDIT_CLIENT_SECRET": "s"}, _found),
        (["setup", "reddit", "--verify"], {"OPENINTEL_REDDIT_CLIENT_ID": "i",
                                           "OPENINTEL_REDDIT_CLIENT_SECRET": "s"}, _unauthorized),
        (["setup", "x", "--verify"], {"OPENINTEL_X_BEARER": "t"}, _found),
        (["setup", "bluesky", "--forget"], {}, None),
    ],
    ids=["guide", "guide-x", "partial", "verify-ok", "verify-401", "verify-x", "forget"],
)
def test_setup_matches_the_reference(capsys, monkeypatch, argv, env, probe):
    """Without a terminal (or with ``--verify``): the guide, the partial
    warning and the verify plan over the environment, the probes
    monkeypatched on both sides; ``--forget`` without a keychain."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    source = argv[1]
    monkeypatch.setitem(tsetup.PROBES, source, probe or _found)
    monkeypatch.setitem(jsetup.PROBES, source, probe or _found)
    monkeypatch.setattr("sys.stdin.isatty", lambda: False, raising=False)
    t_out, t_err, t_code = port(capsys, *argv)
    j_out, j_err, j_code = ref(capsys, *argv)
    assert (t_out, t_err, t_code) == (j_out, j_err, j_code)


# ---------- the surface ----------


def _subcommands(parser):
    action = next(a for a in parser._actions if a.dest == "command")
    return action.choices


def test_every_reference_subcommand_and_flag_is_accepted():
    """Every subcommand of the reference, with its flags and defaults; the
    port adds ``--device`` and takes the multi-process flags of
    ``search``, ``index`` and ``mcp`` with the reference's defaults."""
    t_sub, j_sub = _subcommands(tcli.build_parser()), _subcommands(jcli.build_parser())
    assert sorted(t_sub) == sorted(j_sub)
    for name, j_parser in j_sub.items():
        t_opts = {o: a for a in t_sub[name]._actions for o in a.option_strings}
        for action in j_parser._actions:
            opts = action.option_strings
            if not action.option_strings:
                assert action.dest in {a.dest for a in t_sub[name]._actions}, (name, action.dest)
            for opt in opts:
                assert opt in t_opts, (name, opt)
                if opt not in ("-h", "--help"):
                    assert t_opts[opt].default == action.default, (name, opt)
                    assert t_opts[opt].choices == action.choices, (name, opt)
    for name in DEVICE_COMMANDS:
        device = next(a for a in t_sub[name]._actions if a.dest == "device")
        assert device.default == "cuda" and device.choices == ["cuda", "cpu"]
