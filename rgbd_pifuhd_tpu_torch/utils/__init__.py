"""Options, checkpoint reading and device selection."""
