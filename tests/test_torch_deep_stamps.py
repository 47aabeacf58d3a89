"""The per-tile stamps tool of the D=1024 attention backward, on the CPU.

``perceiver_io_torch/tools/deep_bwd_stamps.py`` reads clock stamps back
from the card; here ``summarise`` turns a synthetic buffer of clocks into
the medians it reports.
"""

from perceiver_io_torch.tools import deep_bwd_stamps as stamps


def test_stamps_summarise_medians():
    phases = ["top", "a", "b"]
    raw = [0] * stamps.SLOTS
    per_ns = 2  # clocks a ns
    for slot in range(16):
        for role in (0, 1):
            base = 64 + (slot * 2 + role) * stamps.ROLE_SLOTS
            for j in range(10):  # tiles of 1000 ns: a 300 ns in, b 700 ns in
                top = 10_000 + j * 1000 * per_ns
                raw[base + j * stamps.NP: base + j * stamps.NP + 3] = [
                    top, top + 300 * per_ns, top + 700 * per_ns]
            head = base + stamps.NT * stamps.NP
            raw[head + 0], raw[head + 1], raw[head + 2] = 4000, 6000, 4000 + 2 * 20_000
            raw[head + 5], raw[head + 6] = 1_000_000, 1_000_000 + 20_000
    got = stamps.summarise(raw, phases)
    for role in ("role0", "role1"):
        assert got[role]["tile"] == 1000.0 and got[role]["a"] == 300.0
        assert got[role]["b"] == 400.0 and got[role]["clock_ghz"] == 2.0
        assert got[role]["start_to_own"] == 1000.0
        assert got[role]["start_to_first_tile"] == 3000.0
