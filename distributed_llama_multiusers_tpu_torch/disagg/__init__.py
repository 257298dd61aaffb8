"""Disaggregated serving: the KV page integrity frame the host swap tier
shares with the page transfer bundles (the bundles themselves are later
work)."""

from .kvtransfer import KVTransferError, page_hash

__all__ = ["KVTransferError", "page_hash"]
