"""Concrete record-table stores (≙ the reference's external siddhi-store-*
extension repos; the SPI they implement lives in core/record_table.py)."""
