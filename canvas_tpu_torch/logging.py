"""{}-format logging + warnonerror decorator.

Capability match for the reference's fluggo/logging.py:20-78: loggers whose
methods accept ``str.format``-style messages, and a decorator that turns
exceptions in callbacks into warnings (the engine must never crash the
render thread because an observer misbehaved).
"""

import functools
import logging as _logging

__all__ = ['getLogger', 'loggerClass']


class _BraceMessage:
    __slots__ = ('fmt', 'args', 'kwargs')

    def __init__(self, fmt, args, kwargs):
        self.fmt = fmt
        self.args = args
        self.kwargs = kwargs

    def __str__(self):
        return str(self.fmt).format(*self.args, **self.kwargs)


class Logger:
    """Wraps a stdlib logger with {}-format methods and warnonerror."""

    def __init__(self, logger):
        if isinstance(logger, str):
            logger = _logging.getLogger(logger)
        self.logger = logger

    def _log(self, level, msg, args, kwargs):
        exc_info = kwargs.pop('exc_info', None)
        if self.logger.isEnabledFor(level):
            self.logger._log(level, _BraceMessage(msg, args, kwargs), (),
                             exc_info=exc_info)

    def debug(self, msg, *args, **kwargs):
        self._log(_logging.DEBUG, msg, args, kwargs)

    def info(self, msg, *args, **kwargs):
        self._log(_logging.INFO, msg, args, kwargs)

    def warning(self, msg, *args, **kwargs):
        self._log(_logging.WARNING, msg, args, kwargs)

    def error(self, msg, *args, **kwargs):
        self._log(_logging.ERROR, msg, args, kwargs)

    def critical(self, msg, *args, **kwargs):
        self._log(_logging.CRITICAL, msg, args, kwargs)

    def exception(self, msg, *args, **kwargs):
        kwargs.setdefault('exc_info', True)
        self._log(_logging.ERROR, msg, args, kwargs)

    def isEnabledFor(self, level):
        return self.logger.isEnabledFor(level)

    def warnonerror(self, msg, *args, **kwargs):
        """Decorator: log exceptions from the wrapped callable as warnings
        (with traceback) instead of letting them propagate."""
        def decorator(func):
            @functools.wraps(func)
            def wrapper(*fargs, **fkwargs):
                try:
                    return func(*fargs, **fkwargs)
                except Exception:
                    kwargs['exc_info'] = True
                    self.warning(msg, *args, **kwargs)
            return wrapper
        return decorator


def getLogger(name):
    return Logger(name)


loggerClass = Logger
