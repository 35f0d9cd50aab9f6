"""Backbone modules and weight conversion."""
