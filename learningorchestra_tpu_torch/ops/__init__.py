"""Dataset operations on the card: PCA (``pca.py``), t-SNE (``tsne.py``)
and the embedding images built from them (``images.py``)."""
