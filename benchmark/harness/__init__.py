"""The benchmark harness: specification, scenes, traffic, the program
under test, the measured window, the check and the trace."""
