"""The benchmark's CPU rehearsal and card tests."""
