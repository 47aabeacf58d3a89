"""The per-tile stamps tool of the D=1024 attention kernels, on the CPU.

``perceiver_io_torch/tools/deep_stamps.py`` reads clock stamps back from
the card; here ``summarise`` turns a synthetic buffer of clocks into the
medians it reports, for the backward's phases and the forward's.
"""

from perceiver_io_torch.tools import deep_stamps as stamps


def _raw(offsets_ns: list, per_ns: int = 2) -> list:
    """A stamps buffer whose sampled warpgroups run 10 tiles of 1000 ns,
    stamp k of a tile ``offsets_ns[k]`` ns after its start, with their
    blocks' starts, owned tiles and ends in the header."""
    raw = [0] * stamps.SLOTS
    for slot in range(16):
        for role in (0, 1):
            base = 64 + (slot * 2 + role) * stamps.ROLE_SLOTS
            for j in range(10):
                top = 10_000 + j * 1000 * per_ns
                raw[base + j * stamps.NP: base + j * stamps.NP + len(offsets_ns)] = [
                    top + off * per_ns for off in offsets_ns]
            head = base + stamps.NT * stamps.NP
            raw[head + 0], raw[head + 1], raw[head + 2] = 4000, 6000, 4000 + 2 * 20_000
            raw[head + 5], raw[head + 6] = 1_000_000, 1_000_000 + 20_000
    return raw


def test_stamps_summarise_medians():
    phases = ["top", "a", "b"]
    got = stamps.summarise(_raw([0, 300, 700]), phases)
    for role in ("role0", "role1"):
        assert got[role]["tile"] == 1000.0 and got[role]["a"] == 300.0
        assert got[role]["b"] == 400.0 and got[role]["clock_ghz"] == 2.0
        assert got[role]["start_to_own"] == 1000.0
        assert got[role]["start_to_first_tile"] == 3000.0


def test_stamps_summarise_forward_phases():
    """The forward's anchors give one phase a stamp after the tile's start,
    and ``summarise`` reads each from the stamp before it."""
    phases = ["top"] + [p for _, p in stamps.FWD_ANCHORS
                        if p not in (stamps.TILE, stamps.START, stamps.OWN, stamps.END)]
    assert len(phases) <= stamps.NP and len(set(phases)) == len(phases)
    offsets = [0] + [5 * k * (k + 1) // 2 for k in range(1, len(phases))]
    got = stamps.summarise(_raw(offsets), phases)
    assert offsets[-1] < 1000
    for role in ("role0", "role1"):
        assert got[role]["tile"] == 1000.0
        for k in range(1, len(phases)):
            assert got[role][phases[k]] == 5.0 * k
        assert got[role]["start_to_own"] == 1000.0
