"""Host data path of the port: vocabulary, tokenizer, readers, datasets."""
