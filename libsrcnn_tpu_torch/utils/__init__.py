"""Utilities of the port: profiling and timing (:mod:`.profiling`)."""
