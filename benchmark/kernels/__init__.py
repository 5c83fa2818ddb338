"""One file a hand-written kernel of the port: the reference op whose calls
it replaces, the names its launches carry in the profiler, and the bytes and
operations a call needs (`work`). The harness finds the files by name."""
