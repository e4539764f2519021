"""``examples/multitenant_serving_torch.py --profile a100`` prints exactly
what ``examples/multitenant_serving.py`` prints: the nine systems over the
same tenants on the reference's ``a100_like`` profile, every digit equal
(the simulator's arithmetic is copied).  Its own file: the two runs take
~20 s on the CPU."""
from test_torch_examples import load, stdout_of


def test_multitenant_serving_a100_prints_the_references_lines(capsys):
    ref = stdout_of(capsys, load("examples/multitenant_serving.py").main)
    got = stdout_of(capsys, lambda: load(
        "examples/multitenant_serving_torch.py").main(["--profile", "a100"]))
    assert got == ref and len(ref.splitlines()) == 10
