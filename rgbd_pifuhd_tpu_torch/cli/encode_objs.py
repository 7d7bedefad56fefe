"""Re-encode OBJ text files to UTF-8 (port of ``cli/encode_objs.py``).

Walks a directory, decodes every ``.obj`` that is not already valid UTF-8
in the source encoding (ISO-8859-9 by default) and rewrites it as UTF-8 in
place; files that already decode as UTF-8 are left alone.

Usage: python -m rgbd_pifuhd_tpu_torch.cli.encode_objs <dir> [--from ISO-8859-9]
"""

from __future__ import annotations

import argparse
import os
import sys


def convert_file(path: str, source_encoding: str = "ISO-8859-9") -> bool:
    """Rewrite one file as UTF-8; returns True if it was changed."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        raw.decode("utf-8")
        return False  # already valid UTF-8
    except UnicodeDecodeError:
        pass
    text = raw.decode(source_encoding)
    with open(path, "wb") as f:
        f.write(text.encode("utf-8"))
    return True


def explore(directory: str, source_encoding: str = "ISO-8859-9") -> int:
    """Convert every .obj under ``directory``; returns count changed."""
    changed = 0
    for root, _dirs, files in os.walk(directory):
        for name in files:
            if os.path.splitext(name)[1].lower() != ".obj":
                continue
            path = os.path.join(root, name)
            try:
                if convert_file(path, source_encoding):
                    print(f"re-encoded: {path}")
                    changed += 1
            except (OSError, UnicodeDecodeError) as e:
                print(f"skip {path}: {e}", file=sys.stderr)
    return changed


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("directory")
    p.add_argument("--from", dest="source", default="ISO-8859-9",
                   help="source encoding of the files to convert")
    args = p.parse_args(argv)
    n = explore(args.directory, args.source)
    print(f"{n} file(s) re-encoded")


if __name__ == "__main__":
    main()
