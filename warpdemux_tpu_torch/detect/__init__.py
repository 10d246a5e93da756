"""Adapter / poly(A) boundary detection."""
