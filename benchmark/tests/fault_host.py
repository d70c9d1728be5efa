"""The port's daemon on the CPU with a fault planted in its engine, for the
tests: ``python3 fault_host.py --fault F <daemon_host.py's arguments>``.

- ``flip_one``: the first lane of each dispatch answered the other way.
- ``drop_half``: only the first half of each dispatch's lanes verified, the
  rest answered valid.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def plant(fault: str) -> None:
    from tmtpu_torch.sidecar import server

    engine = server.SidecarServer._engine_verify

    def broken(self, curve, pks, msgs, sigs, powers, tally):
        if fault == "flip_one":
            mask, tallied, meshed = engine(self, curve, pks, msgs, sigs, powers, tally)
            return [not mask[0]] + list(mask[1:]), tallied, meshed
        half = len(sigs) // 2
        if not half:
            return [True] * len(sigs), sum(powers), 0
        mask, tallied, meshed = engine(self, curve, pks[:half], msgs[:half], sigs[:half],
                                       powers[:half], tally)
        return list(mask) + [True] * (len(sigs) - half), tallied + sum(powers[half:]), meshed

    server.SidecarServer._engine_verify = broken


if __name__ == "__main__":
    i = sys.argv.index("--fault")
    plant(sys.argv[i + 1])
    del sys.argv[i:i + 2]
    from benchmark import daemon_host

    sys.exit(daemon_host.main())
