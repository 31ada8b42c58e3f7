#!/usr/bin/env python
"""Scene driver shim — see flipviscosity3d/cli.py (the reference's
main.cpp as a configurable CLI)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from flipviscosity3d.cli import main

if __name__ == "__main__":
    main()
