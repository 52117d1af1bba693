"""The single-device trainer (``loop.Trainer``) and its steps."""
