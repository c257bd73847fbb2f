"""Command-line tools.  Ported so far: make_pfile (wav -> LPS pfile)."""
