"""Streamlit presentation layer (optional dependency: streamlit)."""
