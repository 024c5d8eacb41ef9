"""Program IR: fixed-shape instruction traces for the executor."""
