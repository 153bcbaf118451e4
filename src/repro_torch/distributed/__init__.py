"""Execution substrate of the port: ranks emulated on one device and their collectives."""
