"""``repro_torch.launch.serve``'s command line against JAX's
(``repro.launch.serve``), on the CPU:

  * JAX's own example command line (its README's ``--reduced --requests 8
    --n-experts 4 --prompt-len 16 --new-tokens 6``) runs on the port as it
    is, with ``--device cpu``: every request served, every prompt 16
    tokens, the pool clean;
  * the flags both commands share take JAX's defaults, but for the two the
    port states as deliberate (``--backend fused``, ``--prompt-len`` a
    range); JAX's defaults are read from its own parser, by running its
    ``main`` with the serving call replaced;
  * ``--prompt-len`` takes one number or a range, and ``--max-len``
    defaults to the longest prompt plus ``--new-tokens``, as JAX's."""
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve

JAX_EXAMPLE = ["--reduced", "--requests", "8", "--n-experts", "4",
               "--prompt-len", "16", "--new-tokens", "6"]
# the shared flags whose defaults differ from JAX's on purpose (ROADMAP.md,
# Differences from JAX)
DIFFER = {"backend", "prompt_len"}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_jax_example_command_line_runs_on_the_port(capsys):
    engine, done = serve.main(JAX_EXAMPLE + ["--device", "cpu"])
    assert len(done) == 8
    assert all(len(r.tokens) == 16 and len(r.output) == 6 for r in done)
    assert engine.max_len == 16 + 6
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "leaked=0" in out


def test_shared_flags_take_jax_s_defaults(monkeypatch):
    seen = {}
    monkeypatch.setattr(jserve, "_serve_single",
                        lambda args, *a, **k: seen.setdefault("args", args))
    monkeypatch.setattr(jserve, "install_flight_dump_signal", lambda p: None)
    jserve.main([])
    want = vars(seen["args"])
    got = vars(serve.parse_args([]))
    shared = sorted((set(want) & set(got)) - DIFFER)
    assert {"n_experts", "hbm_experts", "new_tokens",
            "tagged_fraction"} <= set(shared)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert (want["backend"], got["backend"]) == ("xla", "fused")
    assert want["prompt_len"] == 32 and got["prompt_len"] == (64, 256)


def test_prompt_len_one_number_or_a_range():
    a = serve.parse_args(["--prompt-len", "16"])
    assert a.prompt_len == (16, 16) and a.max_len == 16 + 8
    a = serve.parse_args(["--prompt-len", "8", "20", "--new-tokens", "4"])
    assert a.prompt_len == (8, 20) and a.max_len == 24
    assert serve.parse_args(["--max-len", "64"]).max_len == 64
    reqs, _ = serve.make_requests(5, 100, (16, 16), 2, ["e0"], 0.25)
    assert all(len(r.tokens) == 16 for r in reqs)
    with pytest.raises(SystemExit):
        serve.parse_args(["--prompt-len", "1", "2", "3"])
