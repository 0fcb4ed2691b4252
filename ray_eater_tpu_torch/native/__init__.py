"""The native tier: a C++ PLY reader and PNG codec bound with ctypes
(:mod:`.loader`)."""
