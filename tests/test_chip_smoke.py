"""chip_smoke.py without a GPU: it must exit non-zero and print no
result line, for the one-card run and the four-card option alike."""
import pytest


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_refuses_without_gpu(argv, capsys):
    import chip_smoke

    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err
