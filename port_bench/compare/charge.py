"""The charge comparison: the kept call's data packets against the
benchmark's own charge chain (``reference/charge.py``), by
``check.compare``.

For the module loop of the configuration (``charge.modules``: one pass, or
one a module with module variation) it plans the call's (spill, TPC
group) units as the program does, draws ``check.units`` of them with the
run's ``rng``, recomputes their packets from the call's input and
``rand_seed``, and holds the call's output file to them.
"""
from port_bench import check
from port_bench.reference import charge


def compare(kept: dict, files: dict, cfg: dict, rng, device, log) -> dict:
    """The numbers of ``check.compare`` with the counts they rest on
    (``n_packets``, ``n_file_packets``)."""
    mods = charge.modules(files, cfg['run'])
    tracks = charge.read_segments(kept['input'], mods[0].det)
    calls, groups = charge.plan(tracks, mods)
    sample = charge.choose_units(calls, cfg['check']['units'], rng)
    reference = charge.run(tracks, calls, groups, kept['rand_seed'], sample,
                           device, log=log)
    numbers = check.compare(kept['output'], reference,
                            charge.occupied(calls, groups))
    log(f'[check] charge: units {sample}, {numbers["n_packets"]} packets '
        f'of {numbers["n_file_packets"]} in the file, widest fraction gap '
        f'{numbers["fraction_gap_max"]!r}')
    return numbers
