"""The entries a traffic file can name: each builds the system under
test through the user's constructors, drives it for the window and hands
back a ``core.Outcome``."""
