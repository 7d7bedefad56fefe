"""Drains the mesh files a served run writes, so that 15-25 meshes of
~250 MB a run do not go to disk.

Each mesh path is a FIFO.  This process reads one command a line on its
standard input, ``<fifo path>\\t<copy path or ->``, opens the FIFO (which
waits for the program's writer), reads it to its end, counting the bytes and
writing them on to the copy path when one is given (the meshes the
correctness check reads), and answers ``<bytes>`` on its standard output.
``quit`` ends it.

    python3 portbench/drain.py
"""

from __future__ import annotations

import faulthandler
import fcntl
import os
import signal
import sys

_CHUNK = 1 << 20


def drain(fifo: str, copy: str | None) -> int:
    n = 0
    out = open(copy, "wb") if copy else None
    try:
        fd = os.open(fifo, os.O_RDONLY)
        try:
            try:
                fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, _CHUNK)
            except OSError:
                pass
            while True:
                b = os.read(fd, _CHUNK)
                if not b:
                    break
                n += len(b)
                if out is not None:
                    out.write(b)
        finally:
            os.close(fd)
    finally:
        if out is not None:
            out.close()
    return n


def main() -> None:
    faulthandler.register(signal.SIGTERM, chain=True)
    for line in sys.stdin:
        line = line.rstrip("\n")
        if line == "quit" or not line:
            break
        fifo, copy = line.split("\t")
        n = drain(fifo, None if copy == "-" else copy)
        sys.stdout.write(f"{n}\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
