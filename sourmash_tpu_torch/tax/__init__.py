"""Taxonomy integration ('tax' subcommands and utilities)."""
